// Positions of the first m set entries of a bool[n] flag array.
//
// Replaces pointcloudhookup_tpu/ops/pallas/compactidx.py::compact_indices
// (pallas_call at :134).  out[j] is the position of the (j+1)-th set flag,
// ascending; slots past the number of set flags hold n - 1 (the clipped
// searchsorted convention of the fused front-end's dense-cell table pack).
// Unlike the TPU kernel there is no rule that n be a multiple of 32768.
//
// Bound: device-memory bandwidth: n flag bytes read, 4m bytes written.
// The TPU kernel emitted one position at a time into scalar memory because
// a vector unit cannot scatter; here one kernel reads the flags once:
//   - a block takes the next 16,384-row tile from an atomic counter; each
//     of its 256 threads reads 64 flag bytes with four 16-byte loads and
//     counts them (__vcmpne4, __popc); the block reduces the counts (large
//     tiles: a few hundred tiles at the callers' 4M rows, so few look-back
//     steps);
//   - it publishes the tile's count, warp 0 sums the predecessors' words
//     back to the nearest inclusive prefix (look_back in lookback.cuh), and
//     it publishes its own inclusive prefix;
//   - a tile with no set flag, or whose prefix is already at least m, is
//     done; otherwise a warp scan of the per-thread counts plus the warps'
//     counts gives each set row its slot, and rows below m write their
//     position.
// One or two blocks more than there are tiles fill slots [min(count, m), m)
// with n - 1: their ids come after every tile's, so every tile has started
// when they wait for the last tile's inclusive prefix.  One cudaMemsetAsync
// per call clears the tile counter and the status words.
#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 64;                 // flag bytes a thread loads
constexpr int kWords = kItems / 4;
constexpr int kTile = kThreads * kItems;   // 16,384 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFillBlocks = 128;

__global__ void __launch_bounds__(kThreads)
    compact_indices_kernel(const unsigned char* __restrict__ flag, long long n,
                           int m, int* __restrict__ out,
                           unsigned long long* __restrict__ status,
                           unsigned* __restrict__ next_tile, int ntiles) {
  __shared__ int warp_counts[kWarps];
  __shared__ int s_tile;
  __shared__ int s_total;
  __shared__ long long s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  const int tile = s_tile;
  if (tile >= ntiles) {  // a fill block
    if (threadIdx.x == 0) {
      unsigned long long word;
      do {
        word = read_status(status + ntiles - 1);
      } while ((word >> 32) != kInclusive);
      s_prefix = static_cast<long long>(word & 0xFFFFFFFFull);
    }
    __syncthreads();
    const int fill = static_cast<int>(n - 1);
    const long long stride = static_cast<long long>(gridDim.x - ntiles) * kThreads;
    for (long long i = (s_prefix < m ? s_prefix : m) +
                       static_cast<long long>(tile - ntiles) * kThreads + threadIdx.x;
         i < m; i += stride)
      out[i] = fill;
    return;
  }
  const long long row0 = static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  unsigned w[kWords];  // this thread's flag bytes, each 0 or 1 after the test
  if (row0 + kItems <= n && (reinterpret_cast<uintptr_t>(flag) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(flag + row0);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = src[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {  // the ragged tile, or a view that is not 16-byte aligned
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      w[j] = 0;
      for (int b = 0; b < 4; ++b) {
        const long long r = row0 + 4 * j + b;
        if (r < n && flag[r]) w[j] |= 1u << (8 * b);
      }
    }
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    w[j] = __vcmpne4(w[j], 0u) & 0x01010101u;
    c += __popc(w[j]);
  }
  const int wc = __reduce_add_sync(pch::kFullMask, c);
  if (lane == 0) warp_counts[warp] = wc;
  __syncthreads();
  if (warp == 0) {
    int total = lane < kWarps ? warp_counts[lane] : 0;
    total = __reduce_add_sync(pch::kFullMask, total);
    long long prefix = 0;
    if (tile > 0) {
      if (lane == 0) publish(status + tile, status_word(kAggregate, total));
      prefix = look_back(status, tile);
    }
    if (lane == 0) {
      publish(status + tile, status_word(kInclusive, prefix + total));
      s_total = total;
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const long long prefix = s_prefix;
  if (s_total == 0 || prefix >= m) return;  // uniform across the block
  // slot of this thread's first set row: the tile's prefix, the counts of
  // the warps before, the counts of the lanes before
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(pch::kFullMask, incl, d);
    if (lane >= d) incl += up;
  }
  long long slot = prefix + incl - c;
  for (int q = 0; q < warp; ++q) slot += warp_counts[q];
  if (c == 0 || slot >= m) return;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((w[k >> 2] >> (8 * (k & 3))) & 1u) {
      if (slot < m) out[slot] = static_cast<int>(row0 + k);
      ++slot;
    }
  }
}

}  // namespace

// int32 words of scratch pch_compact_indices needs for n rows: the tile
// counter (and a pad word), then one 64-bit status word per 16,384-row tile.
PCH_API long long pch_compact_indices_scratch(long long n) {
  return 2 + 2LL * pch::blocks_for(n, kTile);
}

// flag: uint8[n] (a torch.bool tensor), 1 <= n < 2**31; out: int32[m];
// scratch: int32[pch_compact_indices_scratch(n)].  m == 0 launches nothing.
PCH_API int pch_compact_indices(const unsigned char* flag, long long n, int m,
                                int* out, int* scratch, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = pch::blocks_for(n, kTile);
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (2 + 2LL * nb) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* next_tile = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  int fill_blocks = pch::blocks_for(m, 8 * kThreads);  // 8 slots a thread at least
  if (fill_blocks > kMaxFillBlocks) fill_blocks = kMaxFillBlocks;
  compact_indices_kernel<<<nb + fill_blocks, kThreads, 0, s>>>(
      flag, n, m, out, status, next_tile, nb);
  return static_cast<int>(cudaGetLastError());
}
