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
// Bound: the projections.  Each labelled row costs 4 products, 2 sums and
// 4 min/max per angle (~79 M (row, angle) pairs at the paths' shapes, 16
// MB of rows at most): ~0.03 ms at the card's full instruction rate.
// The TPU kernel had no atomics and walked each block's label range with
// one-hot masked combines.  Here
// rows arrive cell-sorted, so labels are constant over long runs
// (obb_accum.py:5-10), and every lane stays on projections:
//   * one warp takes a chunk of 64 rows: each lane loads 2, a ballot
//     compacts the labelled ones in order into the warp's shared staging
//     buffer (x, y, z and the label in one float4).  Unlabelled rows cost
//     their load and nothing else; a chunk with none returns at once.
//     Small chunks and small blocks (4 warps) let the block scheduler
//     spread the labelled regions over the card: longer spans a warp, or
//     persistent warps, left whole SMs on one dense region;
//   * lane l owns angles l, l + 32, ... (NQ <= 8 of them, cos/sin and the
//     four extremes in registers), so one broadcast shared load serves
//     NQ angles; rows go two at a time, with no branch between angles;
//   * the six per-cluster statistics are a segmented warp reduction of the
//     staged rows (shuffles over run heads), 32 at a time;
//   * each (run, angle, statistic) flushes ONE atomic a chunk, when the
//     label changes and at the chunk's end.
// A > 256 walks the staged rows again per 256 angles.  Float min/max
// atomics use the ordered-integer trick with -0.0 folded to +0.0.  The
// two variants share the walk and differ only in the row loader.  Two
// launches a call: the output's initial values, then the walk.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block
constexpr int kPerLane = 2;            // rows a lane loads
constexpr int kChunk = 32 * kPerLane;  // rows a warp walks
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

// The six per-cluster statistics of a run.
struct Stat {
  float c, sx, sy, sz, lo, hi;
  __device__ __forceinline__ static Stat empty() {
    return Stat{0.f, 0.f, 0.f, 0.f, kBig, -kBig};
  }
  __device__ __forceinline__ Stat plus(const Stat& o) const {
    return Stat{__fadd_rn(c, o.c),   __fadd_rn(sx, o.sx), __fadd_rn(sy, o.sy),
                __fadd_rn(sz, o.sz), fminf(lo, o.lo),     fmaxf(hi, o.hi)};
  }
  __device__ __forceinline__ Stat shfl_up(int d) const {
    return Stat{__shfl_up_sync(pch::kFullMask, c, d),
                __shfl_up_sync(pch::kFullMask, sx, d),
                __shfl_up_sync(pch::kFullMask, sy, d),
                __shfl_up_sync(pch::kFullMask, sz, d),
                __shfl_up_sync(pch::kFullMask, lo, d),
                __shfl_up_sync(pch::kFullMask, hi, d)};
  }
  __device__ __forceinline__ Stat shfl(int src) const {
    return Stat{__shfl_sync(pch::kFullMask, c, src),
                __shfl_sync(pch::kFullMask, sx, src),
                __shfl_sync(pch::kFullMask, sy, src),
                __shfl_sync(pch::kFullMask, sz, src),
                __shfl_sync(pch::kFullMask, lo, src),
                __shfl_sync(pch::kFullMask, hi, src)};
  }
};

struct Out {
  float *cnt, *sumx, *sumy, *sumz, *zlo, *zhi, *ulo, *uhi, *vlo, *vhi;
  int a;
  __device__ __forceinline__ void flush(int l, const Stat& s) const {
    atomicAdd(cnt + l, s.c);
    atomicAdd(sumx + l, s.sx);
    atomicAdd(sumy + l, s.sy);
    atomicAdd(sumz + l, s.sz);
    atomic_min_f(zlo + l, s.lo);
    atomic_max_f(zhi + l, s.hi);
  }
};

// One warp a chunk of kChunk rows: stage its labelled rows, reduce their
// per-cluster statistics, then walk them once per block of 32 * NQ angles.
template <class Rows, int NQ>
__global__ void __launch_bounds__(kWarps * 32)
    accum_kernel(Rows rows, const int* __restrict__ labels, long long n,
                 const float* __restrict__ cos_a,
                 const float* __restrict__ sin_a, int k, Out out) {
  // the staged rows of each warp: x, y, z and the label's bits
  __shared__ float4 stages[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* st = stages[warp];
  const long long c0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kChunk;
  if (c0 >= n) return;

  // stage the chunk's labelled rows, in order
  int staged = 0;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const long long i = c0 + q * 32 + lane;
    const int l = i < n ? labels[i] : -1;
    const bool keep = l >= 0 && l < k;
    const unsigned m = __ballot_sync(pch::kFullMask, keep);
    if (keep) {
      float4 row;
      rows.load(i, row.x, row.y, row.z);
      row.w = __int_as_float(l);
      st[staged + __popc(m & ((1u << lane) - 1u))] = row;
    }
    staged += __popc(m);
  }
  __syncwarp();
  if (staged == 0) return;

  // the per-cluster statistics: a segmented warp reduction of the staged
  // rows, 32 at a time; a run still open at a group's end carries over
  int carry_l = -1;
  Stat carry = Stat::empty();
  for (int g = 0; g < staged; g += 32) {
    const int nv = staged - g < 32 ? staged - g : 32;
    const bool valid = lane < nv;
    int l = -2;
    Stat s = Stat::empty();
    if (valid) {
      const float4 row = st[g + lane];
      l = __float_as_int(row.w);
      s = Stat{1.f, row.x, row.y, row.z, row.z, row.z};
    }
    const int prev = __shfl_up_sync(pch::kFullMask, l, 1);
    const int next = __shfl_down_sync(pch::kFullMask, l, 1);
    const bool head = valid && (lane == 0 || prev != l);
    const bool tail = valid && (lane == nv - 1 || next != l);
    const unsigned heads = __ballot_sync(pch::kFullMask, head);
    const unsigned tails = __ballot_sync(pch::kFullMask, tail);
    const unsigned upto = lane == 31 ? ~0u : (2u << lane) - 1u;
    const int seg = 31 - __clz(heads & upto);  // this lane's run head
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Stat o = s.shfl_up(d);
      if (lane - d >= seg) s = o.plus(s);
    }
    const int t0 = __ffs(tails) - 1;  // the first run's last lane
    const int l0 = __shfl_sync(pch::kFullMask, l, 0);
    Stat s0 = s.shfl(t0);
    if (l0 == carry_l) {
      s0 = carry.plus(s0);
    } else if (carry_l >= 0 && lane == 0) {
      out.flush(carry_l, carry);
    }
    if (t0 == nv - 1) {  // one run: it stays open
      carry = s0;
      carry_l = l0;
    } else {
      if (lane == 0) out.flush(l0, s0);
      if (tail && lane != t0 && lane != nv - 1) out.flush(l, s);
      carry = s.shfl(nv - 1);
      carry_l = __shfl_sync(pch::kFullMask, l, nv - 1);
    }
  }
  if (lane == 0) out.flush(carry_l, carry);

  // the angle walk: broadcast rows, two at a time, NQ angles a lane
  const int a = out.a;
  for (int j0 = 0; j0 < a; j0 += 32 * NQ) {
    float ca[NQ], sa[NQ], ulo[NQ], uhi[NQ], vlo[NQ], vhi[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = j0 + q * 32 + lane;
      ca[q] = j < a ? cos_a[j] : 0.f;  // angles past A project to 0
      sa[q] = j < a ? sin_a[j] : 0.f;
      ulo[q] = vlo[q] = kBig;
      uhi[q] = vhi[q] = -kBig;
    }
    auto flush = [&](int l) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = j0 + q * 32 + lane;
        if (j < a) {
          const long long o = static_cast<long long>(l) * a + j;
          atomic_min_f(out.ulo + o, ulo[q]);
          atomic_max_f(out.uhi + o, uhi[q]);
          atomic_min_f(out.vlo + o, vlo[q]);
          atomic_max_f(out.vhi + o, vhi[q]);
        }
        ulo[q] = vlo[q] = kBig;
        uhi[q] = vhi[q] = -kBig;
      }
    };
    auto project = [&](float px, float py) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float u = __fadd_rn(__fmul_rn(px, ca[q]), __fmul_rn(py, sa[q]));
        const float v = __fsub_rn(__fmul_rn(py, ca[q]), __fmul_rn(px, sa[q]));
        ulo[q] = fminf(ulo[q], u);
        uhi[q] = fmaxf(uhi[q], u);
        vlo[q] = fminf(vlo[q], v);
        vhi[q] = fmaxf(vhi[q], v);
      }
    };
    int cur = __float_as_int(st[0].w);  // the open run
    int r = 0;
    for (; r + 1 < staged; r += 2) {
      const float4 p0 = st[r];
      const float4 p1 = st[r + 1];
      const int l0 = __float_as_int(p0.w);
      const int l1 = __float_as_int(p1.w);
      if (l0 != cur) {
        flush(cur);
        cur = l0;
      }
      project(p0.x, p0.y);
      if (l1 != cur) {
        flush(cur);
        cur = l1;
      }
      project(p1.x, p1.y);
    }
    if (r < staged) {
      const float4 p0 = st[r];
      const int l0 = __float_as_int(p0.w);
      if (l0 != cur) {
        flush(cur);
        cur = l0;
      }
      project(p0.x, p0.y);
    }
    flush(cur);
  }
}

// out: float32[6k + 4ka], initialized here; then the walk.
template <class Rows>
int launch(Rows rows, const int* labels, long long n, const float* cos_a,
           const float* sin_a, int k, int a, float* out, void* stream) {
  if (n < 0 || k < 0 || a < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ka = static_cast<long long>(k) * a;
  const long long total = 6LL * k + 4LL * ka;
  if (total > 0) {
    int grid = pch::blocks_for(total, 256);
    if (grid > 1024) grid = 1024;
    init_kernel<<<grid, 256, 0, s>>>(out, k, a);
  }
  if (n > 0 && k > 0 && a > 0) {
    const Out o{out,          out + k,      out + 2 * k,  out + 3 * k,
                out + 4 * k,  out + 5 * k,  out + 6 * k,  out + 6 * k + ka,
                out + 6 * k + 2 * ka, out + 6 * k + 3 * ka, a};
    const int grid = pch::blocks_for(n, static_cast<long long>(kWarps) * kChunk);
    const int groups = (a < 256 ? a + 31 : 256) / 32;  // angle groups a lane
    if (groups <= 1) {
      accum_kernel<Rows, 1><<<grid, kWarps * 32, 0, s>>>(rows, labels, n, cos_a, sin_a, k, o);
    } else if (groups <= 2) {
      accum_kernel<Rows, 2><<<grid, kWarps * 32, 0, s>>>(rows, labels, n, cos_a, sin_a, k, o);
    } else if (groups <= 4) {
      accum_kernel<Rows, 4><<<grid, kWarps * 32, 0, s>>>(rows, labels, n, cos_a, sin_a, k, o);
    } else {
      accum_kernel<Rows, 8><<<grid, kWarps * 32, 0, s>>>(rows, labels, n, cos_a, sin_a, k, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, z: float32[n]; labels: int32[n]; cos_a, sin_a: float32[a];
// out: float32[6k + 4ka].
PCH_API int pch_obb_accumulate_xyz(const float* x, const float* y,
                                   const float* z, const int* labels,
                                   long long n, const float* cos_a,
                                   const float* sin_a, int k, int a,
                                   float* out, void* stream) {
  return launch(XyzRows{x, y, z}, labels, n, cos_a, sin_a, k, a, out, stream);
}

// hi, lo: int32[n] Morton words; labels: int32[n]; off: float32[3] on the
// device, mn + vs / 2; vs: the voxel size; cos_a, sin_a: float32[a];
// out: float32[6k + 4ka].
PCH_API int pch_obb_accumulate(const int* hi, const int* lo, const int* labels,
                               long long n, const float* off, float vs,
                               const float* cos_a, const float* sin_a, int k,
                               int a, float* out, void* stream) {
  return launch(MortonRows{hi, lo, off, vs}, labels, n, cos_a, sin_a, k, a,
                out, stream);
}
