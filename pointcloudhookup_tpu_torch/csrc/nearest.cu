// ICP's nearest-neighbour sweep: each frame row moved by (R, t), then the
// index and squared distance of its nearest valid destination row, and
// that row (ops/kernels/nearest.py::nearest_moved, called by
// ops/registration.py::batched_icp once a sweep).
//
// Replaces no TPU kernel: the JAX module's _nearest
// (pointcloudhookup_tpu/ops/registration.py) is plain jnp, which XLA fuses
// on the TPU.  The port's plain version builds [B, rows, M] float32 d^2
// tiles and sends each through about a dozen elementwise and reduce
// launches; on the H100 those passes took ~96 % of the ICP's device time.
// Here the moved rows, each pair's d^2 and the running argmin stay in
// registers, so no [B, rows, M] tensor exists.
//
// Bit-equal to the plain version on the card: the moved row in _dot3's
// order, fma(s2, r2, fma(s1, r1, s0 r0)) + t; d^2 = |a - b|^2 as
// differences, the square of the first and two fused multiply-adds; the
// argmin as torch.argmin takes it (the least d^2, the smallest index on
// equal d^2, a masked destination as +inf, so a row whose every candidate
// is +inf keeps index 0, and the first NaN wins over everything).
//
// Bound: the operations portbench/metrics/icp_roofline.py counts, 6 float32
// operations a (frame row, destination row) pair; the destination rows
// (8.4 MB in the icp50 cell) stay in L2.  Reproducing the plain version's
// rounding takes 6 issued instructions a pair (three subtractions, a
// product, two fused multiply-adds) and the strict-less compare-and-keep
// about 3 more, so about a third of the bound is the ceiling.  Design: a
// block stages chunks of one tower's destination rows in shared memory as
// float4 (a masked row as +inf, which never wins a strict <); each thread
// holds R moved frame rows in registers, so one broadcast load feeds R
// pairs, and walks its rows in ascending order with a strict <; the warps
// of a block split each chunk's rows and the blocks split the tower's
// rows (nearest.py::plan picks the split from B, N and M), their partial
// minima merged by atomicMin on the 64-bit key (d^2 bits + 1) << 32 |
// index, which orders (d^2, index) as torch.argmin does, NaN (key 0 << 32)
// first.  A chunk without a valid row is skipped after its staging, so the
// padding of pad_pairs' prefix masks costs one pass over the mask.  A NaN
// d^2 needs a non-finite coordinate, so the NaN search runs only for a row
// that is non-finite itself or in a block whose range holds a valid
// non-finite destination row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 512;  // destination rows a block stages at once
constexpr int kMaxWarps = 8;
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// the order of ops/registration.py::_nearest: the differences, the square of
// the first, then two fused multiply-adds
__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  const float e0 = __fsub_rn(ax, bx);
  const float e1 = __fsub_rn(ay, by);
  const float e2 = __fsub_rn(az, bz);
  float d = __fmul_rn(e0, e0);
  d = __fmaf_rn(e1, e1, d);
  return __fmaf_rn(e2, e2, d);
}

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  const unsigned e = 0x7f800000u;
  return (__float_as_uint(x) & e) != e && (__float_as_uint(y) & e) != e &&
         (__float_as_uint(z) & e) != e;
}

// (d^2, index) as one ordered word: d^2 >= 0 and +inf order as their bits;
// a NaN comes before every number
__device__ __forceinline__ unsigned long long pair_key(float d2, unsigned j) {
  const unsigned hi = is_nan(d2) ? 0u : __float_as_uint(d2) + 1u;
  return (static_cast<unsigned long long>(hi) << 32) | j;
}

// Block (tower b, a group of wt frame-row tiles of 32 * R rows, one of
// split ranges of `span` destination rows).  Warp w holds tile w % wt and
// walks the rows k = w / wt, w / wt + wm, ... of each staged chunk.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
sweep_kernel(const float* __restrict__ src, const float* __restrict__ dst,
             const unsigned char* __restrict__ dmask, const float* __restrict__ rot,
             const float* __restrict__ trans, long long n, long long m, int wt, int wm,
             int groups, long long span, unsigned long long* __restrict__ keys) {
  __shared__ float4 stage[kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = warp / wt;
  const long long b = blockIdx.x / groups;
  const long long tile = static_cast<long long>(blockIdx.x % groups) * wt + warp % wt;
  const long long first = tile * (32 * R);  // the warp's first frame row
  const bool busy = first < n;

  float ax[R], ay[R], az[R], best[R];
  unsigned bi[R];
  bool odd = false;  // a moved row of this thread is not finite
  {
    float rm[9], tv[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) rm[k] = __ldg(rot + b * 9 + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) tv[k] = __ldg(trans + b * 3 + k);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long i = first + q * 32 + lane;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      if (i < n) {
        const float* p = src + (b * n + i) * 3;
        s0 = __ldg(p);
        s1 = __ldg(p + 1);
        s2 = __ldg(p + 2);
      }
      float a[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a[c] = __fadd_rn(
            __fmaf_rn(s2, rm[3 * c + 2], __fmaf_rn(s1, rm[3 * c + 1], __fmul_rn(s0, rm[3 * c]))),
            tv[c]);
      ax[q] = a[0];
      ay[q] = a[1];
      az[q] = a[2];
      best[q] = f32_inf();
      bi[q] = 0u;
      odd |= i < n && !finite3(a[0], a[1], a[2]);
    }
  }

  const long long m0 = static_cast<long long>(blockIdx.y) * span;
  const long long m1 = m0 + span < m ? m0 + span : m;
  int bad = 0;  // a valid destination row of the range is not finite
  for (long long c0 = m0; c0 < m1; c0 += kChunk) {
    const int len = static_cast<int>(m1 - c0 < kChunk ? m1 - c0 : kChunk);
    int valid = 0, nonfinite = 0;
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      const long long j = b * m + c0 + k;
      float4 v = make_float4(f32_inf(), f32_inf(), f32_inf(), 0.f);
      if (dmask[j]) {
        const float* p = dst + j * 3;
        v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
        valid = 1;
        nonfinite |= !finite3(v.x, v.y, v.z);
      }
      stage[k] = v;
    }
    valid = __syncthreads_or(valid);
    bad |= __syncthreads_or(nonfinite);
    if (valid && busy) {
#pragma unroll 4
      for (int k = slice; k < len; k += wm) {
        const float4 v = stage[k];
        const unsigned j = static_cast<unsigned>(c0 + k);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float d = sq_dist(ax[q], ay[q], az[q], v.x, v.y, v.z);
          if (d < best[q]) {
            best[q] = d;
            bi[q] = j;
          }
        }
      }
    }
    __syncthreads();  // the chunk is read before the next one is staged
  }
  if (!busy) return;

  if (bad || odd) {  // NaN wins: the first valid row of the slice giving one
#pragma unroll
    for (int q = 0; q < R; ++q) {
      for (long long j = m0 + slice; j < m1; j += wm) {
        if (!dmask[b * m + j]) continue;
        const float* p = dst + (b * m + j) * 3;
        const float d = sq_dist(ax[q], ay[q], az[q], __ldg(p), __ldg(p + 1), __ldg(p + 2));
        if (is_nan(d)) {
          best[q] = d;
          bi[q] = static_cast<unsigned>(j);
          break;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long i = first + q * 32 + lane;
    if (i < n) atomicMin(keys + b * n + i, pair_key(best[q], bi[q]));
  }
}

// One thread a frame row: the merged key as index and d^2 (+inf for a
// masked frame row, as the plain version's), and the matched row.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const unsigned long long* __restrict__ keys,
              const unsigned char* __restrict__ smask, const float* __restrict__ dst,
              long long n, long long m, long long rows, long long* __restrict__ idx,
              float* __restrict__ d2, float* __restrict__ matched) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const unsigned long long key = keys[i];
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned j = static_cast<unsigned>(key);
  // a NaN d^2 is the card's canonical NaN, as the plain version's arithmetic
  // leaves it
  const float d = hi == 0u ? __int_as_float(0x7fffffff) : __uint_as_float(hi - 1u);
  idx[i] = j;
  d2[i] = smask[i] ? d : f32_inf();
  const float* p = dst + ((i / n) * m + j) * 3;
  matched[3 * i] = p[0];
  matched[3 * i + 1] = p[1];
  matched[3 * i + 2] = p[2];
}

template <int R>
cudaError_t launch_sweep(const float* src, const float* dst, const unsigned char* dmask,
                         const float* rot, const float* trans, long long b, long long n,
                         long long m, int wt, int wm, int split,
                         unsigned long long* keys, cudaStream_t s) {
  const long long tiles = (n + 32 * R - 1) / (32 * R);
  const int groups = static_cast<int>((tiles + wt - 1) / wt);
  const long long span = (m + split - 1) / split;
  const dim3 grid(static_cast<unsigned>(groups * b), static_cast<unsigned>(split));
  sweep_kernel<R><<<grid, 32 * wt * wm, 0, s>>>(src, dst, dmask, rot, trans, n, m, wt, wm,
                                                groups, span, keys);
  return cudaGetLastError();
}

}  // namespace

// src float32[b, n, 3], src_mask uint8[b, n], dst float32[b, m, 3], dst_mask
// uint8[b, m], rot float32[b, 3, 3], trans float32[b, 3]; rows (2, 3 or 4
// frame rows a thread), wt x wm warps a block (wt * wm <= 8) and split
// destination ranges from nearest.py::plan; keys: b * n uint64 of scratch;
// outputs idx int64[b, n], d2 float32[b, n], matched float32[b, n, 3].
// Three launches: a memset of the keys, the sweep, the finish.
PCH_API int pch_nearest_sweep(const float* src, const unsigned char* src_mask,
                              const float* dst, const unsigned char* dst_mask,
                              const float* rot, const float* trans, long long b,
                              long long n, long long m, int rows, int wt, int wm,
                              int split, void* keys, long long* idx, float* d2,
                              float* matched, void* stream) {
  if (b < 0 || n < 0 || m < 1 || n > 0x7fffffffLL || m > 0x7fffffffLL || rows < 2 ||
      rows > 4 || wt < 1 || wm < 1 || wt * wm > kMaxWarps || split < 1 || split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = b * n;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, total * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* k = static_cast<unsigned long long*>(keys);
  switch (rows) {
    case 2:
      e = launch_sweep<2>(src, dst, dst_mask, rot, trans, b, n, m, wt, wm, split, k, s);
      break;
    case 3:
      e = launch_sweep<3>(src, dst, dst_mask, rot, trans, b, n, m, wt, wm, split, k, s);
      break;
    default:
      e = launch_sweep<4>(src, dst, dst_mask, rot, trans, b, n, m, wt, wm, split, k, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  finish_kernel<<<pch::blocks_for(total, kFinishThreads), kFinishThreads, 0, s>>>(
      k, src_mask, dst, n, m, total, idx, d2, matched);
  return static_cast<int>(cudaGetLastError());
}
