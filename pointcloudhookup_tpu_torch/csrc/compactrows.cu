// Order-preserving stream compaction of up to 8 int32 channels, in one pass.
//
// Replaces pointcloudhookup_tpu/ops/pallas/compactrows.py::compact_rows_multi
// (pallas_call at :360) and the sentinel fill of its Morton wrapper
// compact_rows.  Rows where keep != 0 move, in input order, to the front of
// [cap] outputs; rows at or past min(count, cap) hold the channel's fill
// value; the TRUE kept count (which may exceed cap) is written to *count.
//
// Bound: device-memory bandwidth.  The function reads keep and every
// channel once and writes every output row once.  The TPU kernel routed rows
// through a butterfly network because scatters serialize there; here one
// kernel counts, scans and scatters by the decoupled look-back scan:
//   - a block takes the next 4,096-row tile from an atomic counter, so every
//     tile before it has started and will publish;
//   - each of its 256 threads reads 16 keep bytes with one 16-byte load,
//     counts them, and the block scans the counts;
//   - the block publishes its tile's count; warp 0 sums the predecessors'
//     published words back to the nearest inclusive prefix (a flag and a
//     32-bit value in one 64-bit word, so a word is read whole or not at
//     all); the block publishes its own inclusive prefix;
//   - per channel, the block reads the tile's rows striped (neighbouring
//     threads on neighbouring rows; a row that is not kept is not loaded, so
//     sectors without a kept row never leave memory), stages the kept rows
//     compacted in shared memory and writes them to out[pos, pos + kept) as
//     one coalesced run.
// A few blocks more than there are tiles fill rows [min(count, cap), cap)
// with the fill values: their ids come after every tile's, so every tile has
// started when they wait for the last tile's inclusive prefix, and the wait
// holds up no tile.  One cudaMemsetAsync per call clears the count, the tile
// counter and the status words; one kernel launch does the rest.
#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int kMaxChannels = 8;
constexpr int kRowThreads = 256;
constexpr int kRowItems = 16;                      // keep bytes a thread loads
constexpr int kRowTile = kRowThreads * kRowItems;  // 4096 rows
constexpr unsigned kAggregate = 1;                 // status flags (high word)
constexpr unsigned kInclusive = 2;
constexpr int kMaxFillBlocks = 128;

// Passed as a __grid_constant__ parameter: indexed by channel in place,
// without a copy to the stack.
struct Channels {
  const int* in[kMaxChannels];
  int fill[kMaxChannels];
};

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          long long value) {
  return (static_cast<unsigned long long>(flag) << 32) |
         static_cast<unsigned>(value);
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(status) = word;
}

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* status) {
  return *reinterpret_cast<const volatile unsigned long long*>(status);
}

// The rows before `tile` kept in all, by warp 0: lane i reads the status of
// tile - 1 - i (spinning until it is published), and the warp adds the words
// up to the nearest inclusive prefix, 32 tiles a step.
__device__ long long look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long prefix = 0;
  for (int last = tile - 1;; last -= 32) {
    const int idx = last - lane;
    unsigned long long word = status_word(kInclusive, 0);  // before tile 0
    if (idx >= 0) {
      do {
        word = read_status(status + idx);
      } while ((word >> 32) == 0);
    }
    const unsigned incl = __ballot_sync(pch::kFullMask, (word >> 32) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(word & 0xFFFFFFFFull) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(pch::kFullMask, v, off);
    prefix += v;
    if (incl) return prefix;
  }
}

// Rows [min(count, cap), cap) of every channel <- its fill value, by fill
// block `block` of `blocks`.
__device__ void fill_tail(long long count, const Channels& ch, int nchan,
                          int* __restrict__ out, long long cap, int block,
                          int blocks) {
  const long long first = count < cap ? count : cap;
  const long long stride = static_cast<long long>(blocks) * kRowThreads;
  for (long long i = first + static_cast<long long>(block) * kRowThreads + threadIdx.x;
       i < cap; i += stride) {
    for (int q = 0; q < nchan; ++q) out[q * cap + i] = ch.fill[q];
  }
}

__global__ void __launch_bounds__(kRowThreads)
    compact_kernel(const unsigned char* __restrict__ keep, long long n,
                   const __grid_constant__ Channels ch, int nchan,
                   int* __restrict__ out, long long cap,
                   unsigned long long* __restrict__ status,
                   unsigned* __restrict__ next_tile, int* __restrict__ count,
                   int ntiles) {
  __shared__ __align__(16) short s_slot[kRowTile];  // place among the kept, or -1
  __shared__ int s_stage[kRowTile];
  __shared__ int warp_sums[kRowThreads / 32];
  __shared__ int s_tile;
  __shared__ long long s_prefix;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  const int tile = s_tile;
  if (tile >= ntiles) {  // a fill block
    if (threadIdx.x == 0) {
      unsigned long long word = status_word(kInclusive, 0);  // no tile: n == 0
      if (ntiles > 0) {
        do {
          word = read_status(status + ntiles - 1);
        } while ((word >> 32) != kInclusive);
      }
      s_prefix = static_cast<long long>(word & 0xFFFFFFFFull);
    }
    __syncthreads();
    fill_tail(s_prefix, ch, nchan, out, cap, tile - ntiles, gridDim.x - ntiles);
    return;
  }
  const long long base = static_cast<long long>(tile) * kRowTile;
  const long long row0 = base + threadIdx.x * kRowItems;
  unsigned w[4];  // this thread's 16 keep bytes, each 0 or 1
  if (row0 + kRowItems <= n && (reinterpret_cast<uintptr_t>(keep) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + row0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = 0;
      for (int b = 0; b < 4; ++b) {
        const long long r = row0 + 4 * j + b;
        if (r < n && keep[r]) w[j] |= 1u << (8 * b);
      }
    }
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = __vcmpne4(w[j], 0u) & 0x01010101u;
    c += __popc(w[j]);
  }
  int total;
  int slot = block_exclusive_sum<kRowThreads>(c, warp_sums, &total);
  unsigned pairs[kRowItems / 2];  // the 16 slots as shorts, two a word
#pragma unroll
  for (int q = 0; q < kRowItems; ++q) {
    const bool kept = (w[q >> 2] >> (8 * (q & 3))) & 1u;
    const unsigned sl = static_cast<unsigned short>(kept ? slot++ : -1);
    pairs[q >> 1] = (q & 1) ? pairs[q >> 1] | (sl << 16) : sl;
  }
  uint4* own = reinterpret_cast<uint4*>(s_slot + threadIdx.x * kRowItems);
  own[0] = make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
  own[1] = make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
  if (threadIdx.x < 32) {
    long long prefix = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) publish(status + tile, status_word(kAggregate, total));
      prefix = look_back(status, tile);
    }
    if (threadIdx.x == 0) {
      publish(status + tile, status_word(kInclusive, prefix + total));
      if (tile == ntiles - 1) *count = static_cast<int>(prefix + total);
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const long long pos0 = s_prefix;
  if (pos0 >= cap) return;  // uniform: this tile's rows lie past the capacity
  const int nwrite = cap - pos0 < total ? static_cast<int>(cap - pos0) : total;
  int at[kRowItems];  // slots of the striped rows threadIdx.x + j * kRowThreads
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) at[j] = s_slot[threadIdx.x + j * kRowThreads];
  for (int q = 0; q < nchan; ++q) {
    const int* in = ch.in[q] + base;
    int v[kRowItems];
#pragma unroll
    for (int j = 0; j < kRowItems; ++j)
      v[j] = at[j] >= 0 ? in[threadIdx.x + j * kRowThreads] : 0;
#pragma unroll
    for (int j = 0; j < kRowItems; ++j)
      if (at[j] >= 0) s_stage[at[j]] = v[j];
    __syncthreads();
    int* o = out + q * cap + pos0;
    for (int i = threadIdx.x; i < nwrite; i += kRowThreads) o[i] = s_stage[i];
    __syncthreads();
  }
}

}  // namespace

PCH_API int pch_max_channels() { return kMaxChannels; }

// int32 words of scratch pch_compact_rows needs for n rows (a multiple of
// 4, so that outputs placed after it stay 16-byte aligned): the count, the
// tile counter, then one 64-bit status word per 4,096-row tile.
PCH_API long long pch_compact_rows_scratch(long long n) {
  const long long words = 2 + 2LL * pch::blocks_for(n, kRowTile);
  return (words + 3) / 4 * 4;
}

// keep: uint8[n] (a torch.bool tensor), n < 2**31; in: host array of nchan
// device pointers to int32[n]; fills: host array of nchan tail values, or
// null for zeros; out: int32[nchan, cap] (channel q at out + q * cap);
// scratch: int32[pch_compact_rows_scratch(n)], whose first word receives the
// true kept count.
PCH_API int pch_compact_rows(const unsigned char* keep, long long n,
                             const void* const* in, const int* fills,
                             int nchan, int* out, long long cap, int* scratch,
                             void* stream) {
  if (nchan < 0 || nchan > kMaxChannels || n < 0 || n > 0x7FFFFFFFLL || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Channels ch{};
  for (int q = 0; q < nchan; ++q) {
    ch.in[q] = static_cast<const int*>(in[q]);
    ch.fill[q] = fills != nullptr ? fills[q] : 0;
  }
  const int nb = pch::blocks_for(n, kRowTile);
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (2 + 2LL * nb) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* count = scratch;
  unsigned* next_tile = reinterpret_cast<unsigned*>(scratch + 1);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  int fill_blocks = 0;  // 8 rows a thread at least
  if (cap > 0 && nchan > 0) fill_blocks = pch::blocks_for(cap, 8 * kRowThreads);
  if (fill_blocks > kMaxFillBlocks) fill_blocks = kMaxFillBlocks;
  if (nb + fill_blocks > 0)
    compact_kernel<<<nb + fill_blocks, kRowThreads, 0, s>>>(
        keep, n, ch, nchan, out, cap, status, next_tile, count, nb);
  return static_cast<int>(cudaGetLastError());
}
