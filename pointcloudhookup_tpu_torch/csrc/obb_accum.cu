// Sort-free per-cluster OBB accumulation, over raw coordinates or over
// Morton-coded voxel rows.
//
// Replaces pointcloudhookup_tpu/ops/pallas/obb_accum.py::obb_accumulate_xyz
// (pallas_call at :346) and ::obb_accumulate (pallas_call at :222).  Rows
// with a label in [0, K) accumulate
//   per cluster:          cnt, sx, sy, sz (sums), zlo, zhi
//   per (cluster, angle): ulo, uhi, vlo, vhi of
//                         u = x cos + y sin,  v = y cos - x sin
// at angle j * (pi/2) / A; labels >= K or < 0 are skipped.  The Morton
// variant decodes each row's voxel centre in the loader:
//   x = fmaf(float(_compact10(lo >> 0) | _compact10(hi >> 0) << 10), vs, off_x)
// (y with shift 1, z with shift 2), off = mn + vs/2 rounded once, as the
// TPU kernel computes it (obb_accum.py:141-143, 204-205); the product and
// sum round once, as XLA:CPU compiles that line (a fused multiply-add).
//
// Bound: atomics.  Every row of a cluster updates the same 4 x A
// addresses, so a row-per-thread atomic pass would issue ~1e3 atomics per
// row (~3e8 at the 4M tile), all contending.  The TPU kernel had no
// atomics and walked each block's label range with one-hot masked
// combines.  Here rows arrive cell-sorted, so labels are constant over
// long runs (obb_accum.py:5-10): a block stages a 512-row tile in shared
// memory and each thread owns one angle, walks the tile in order, and
// reduces each label run in registers before flushing ONE atomic per
// (run, angle, statistic).  A warp-shuffle pre-reduction would divide the
// atomics by 32; the run walk divides them by the run length (up to 512).
// Thread 0 also reduces the per-cluster sums and z extremes of each run.
// Tiles with no labelled row exit after one barrier.  Float min/max
// atomics use the ordered-integer trick with -0.0 folded to +0.0.  The two
// variants share the tile walk and differ only in the row loader.
#include "common.cuh"

namespace {

constexpr int kRows = 512;
constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ void atomic_min_f(float* addr, float v) {
  if (v == 0.f) v = 0.f;  // -0.0 -> +0.0 keeps the integer order total
  if (v >= 0.f) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f(float* addr, float v) {
  if (v == 0.f) v = 0.f;
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// out layout: cnt, sx, sy, sz, zlo, zhi [K each], then ulo, uhi, vlo, vhi
// [K, A each].
__global__ void init_kernel(float* __restrict__ out, int k, int a) {
  const long long ka = static_cast<long long>(k) * a;
  const long long total = 6LL * k + 4 * ka;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v;
    if (i < 4LL * k) {
      v = 0.f;
    } else if (i < 5LL * k) {
      v = kBig;  // zlo
    } else if (i < 6LL * k) {
      v = -kBig;  // zhi
    } else {
      const long long q = (i - 6LL * k) / ka;  // 0 ulo, 1 uhi, 2 vlo, 3 vhi
      v = (q == 0 || q == 2) ? kBig : -kBig;
    }
    out[i] = v;
  }
}

// Row loaders: the coordinates of row i.
struct XyzRows {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ z;
  __device__ __forceinline__ void load(long long i, float& px, float& py,
                                       float& pz) const {
    px = x[i];
    py = y[i];
    pz = z[i];
  }
};

__device__ __forceinline__ int compact10(int x) {
  x &= 0x09249249;
  x = (x | (x >> 2)) & 0x030C30C3;
  x = (x | (x >> 4)) & 0x0300F00F;
  x = (x | (x >> 8)) & 0x030000FF;
  x = (x | (x >> 16)) & 0x3FF;
  return x;
}

struct MortonRows {
  const int* __restrict__ hi;
  const int* __restrict__ lo;
  const float* __restrict__ off;  // float32[3]: mn + vs / 2
  float vs;                       // voxel size
  __device__ __forceinline__ float axis(int h, int l, int s) const {
    const int v = compact10(l >> s) | (compact10(h >> s) << 10);
    return __fmaf_rn(static_cast<float>(v), vs, off[s]);
  }
  __device__ __forceinline__ void load(long long i, float& px, float& py,
                                       float& pz) const {
    const int h = hi[i];
    const int l = lo[i];
    px = axis(h, l, 0);
    py = axis(h, l, 1);
    pz = axis(h, l, 2);
  }
};

template <class Rows>
__global__ void accum_kernel(Rows rows, const int* __restrict__ labels,
                             long long n, const float* __restrict__ cos_a,
                             const float* __restrict__ sin_a, int k, int a,
                             float* __restrict__ out) {
  __shared__ float sx[kRows];
  __shared__ float sy[kRows];
  __shared__ float sz[kRows];
  __shared__ int sl[kRows];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long rest = n - r0;
  const int len = rest < kRows ? static_cast<int>(rest) : kRows;
  int any = 0;
  for (int r = threadIdx.x; r < len; r += kThreads) {
    int l = labels[r0 + r];
    if (l >= k || l < 0) l = -1;
    sl[r] = l;
    rows.load(r0 + r, sx[r], sy[r], sz[r]);
    any |= l >= 0;
  }
  if (!__syncthreads_or(any)) return;

  const long long ka = static_cast<long long>(k) * a;
  float* cnt = out;
  float* sumx = out + k;
  float* sumy = out + 2 * k;
  float* sumz = out + 3 * k;
  float* zlo = out + 4 * k;
  float* zhi = out + 5 * k;
  float* ulo = out + 6 * k;
  float* uhi = ulo + ka;
  float* vlo = uhi + ka;
  float* vhi = vlo + ka;

  if (threadIdx.x == 0) {
    int cur = -1;
    float c = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, lo = kBig, hi = -kBig;
    for (int r = 0; r <= len; ++r) {
      const int l = r < len ? sl[r] : -1;
      if (l != cur) {
        if (cur >= 0) {
          atomicAdd(cnt + cur, c);
          atomicAdd(sumx + cur, s1);
          atomicAdd(sumy + cur, s2);
          atomicAdd(sumz + cur, s3);
          atomic_min_f(zlo + cur, lo);
          atomic_max_f(zhi + cur, hi);
        }
        cur = l;
        c = s1 = s2 = s3 = 0.f;
        lo = kBig;
        hi = -kBig;
      }
      if (l >= 0) {
        c = __fadd_rn(c, 1.f);
        s1 = __fadd_rn(s1, sx[r]);
        s2 = __fadd_rn(s2, sy[r]);
        s3 = __fadd_rn(s3, sz[r]);
        lo = fminf(lo, sz[r]);
        hi = fmaxf(hi, sz[r]);
      }
    }
  }

  for (int j = threadIdx.x; j < a; j += kThreads) {
    const float ca = cos_a[j];
    const float sa = sin_a[j];
    int cur = -1;
    float u_lo = kBig, u_hi = -kBig, v_lo = kBig, v_hi = -kBig;
    for (int r = 0; r <= len; ++r) {
      const int l = r < len ? sl[r] : -1;
      if (l != cur) {
        if (cur >= 0) {
          const long long o = static_cast<long long>(cur) * a + j;
          atomic_min_f(ulo + o, u_lo);
          atomic_max_f(uhi + o, u_hi);
          atomic_min_f(vlo + o, v_lo);
          atomic_max_f(vhi + o, v_hi);
        }
        cur = l;
        u_lo = v_lo = kBig;
        u_hi = v_hi = -kBig;
      }
      if (l >= 0) {
        const float px = sx[r];
        const float py = sy[r];
        const float u = __fadd_rn(__fmul_rn(px, ca), __fmul_rn(py, sa));
        const float v = __fsub_rn(__fmul_rn(py, ca), __fmul_rn(px, sa));
        u_lo = fminf(u_lo, u);
        u_hi = fmaxf(u_hi, u);
        v_lo = fminf(v_lo, v);
        v_hi = fmaxf(v_hi, v);
      }
    }
  }
}

// out: float32[6k + 4ka], initialized here; then one pass over the rows.
template <class Rows>
int launch(Rows rows, const int* labels, long long n, const float* cos_a,
           const float* sin_a, int k, int a, float* out, void* stream) {
  if (n < 0 || k < 0 || a < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = 6LL * k + 4LL * k * a;
  if (total > 0) {
    int grid = pch::blocks_for(total, 256);
    if (grid > 1024) grid = 1024;
    init_kernel<<<grid, 256, 0, s>>>(out, k, a);
  }
  if (n > 0 && k > 0) {
    accum_kernel<<<pch::blocks_for(n, kRows), kThreads, 0, s>>>(
        rows, labels, n, cos_a, sin_a, k, a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, z: float32[n]; labels: int32[n]; cos_a, sin_a: float32[a].
PCH_API int pch_obb_accumulate_xyz(const float* x, const float* y,
                                   const float* z, const int* labels,
                                   long long n, const float* cos_a,
                                   const float* sin_a, int k, int a,
                                   float* out, void* stream) {
  return launch(XyzRows{x, y, z}, labels, n, cos_a, sin_a, k, a, out, stream);
}

// hi, lo: int32[n] Morton words; labels: int32[n]; off: float32[3] on the
// device, mn + vs / 2; vs: the voxel size; cos_a, sin_a: float32[a].
PCH_API int pch_obb_accumulate(const int* hi, const int* lo, const int* labels,
                               long long n, const float* off, float vs,
                               const float* cos_a, const float* sin_a, int k,
                               int a, float* out, void* stream) {
  return launch(MortonRows{hi, lo, off, vs}, labels, n, cos_a, sin_a, k, a,
                out, stream);
}
