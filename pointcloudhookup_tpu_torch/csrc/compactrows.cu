// Order-preserving stream compaction of up to 8 int32 channels.
//
// Replaces pointcloudhookup_tpu/ops/pallas/compactrows.py::compact_rows_multi
// (pallas_call at :360).  Rows where keep != 0 move, in input order, to the
// front of [cap] outputs; rows at or past min(count, cap) are zero; the TRUE
// kept count (which may exceed cap) is written to scratch[nb].
//
// Bound: device-memory bandwidth.  Each row is read twice (count pass and
// scatter pass) and each kept row written once per channel; the arithmetic
// is a block scan.  The TPU kernel routed rows through a butterfly network
// because scatters serialize there; Hopper scatters natively, so this is
// the textbook three-phase scan + scatter:
//   1. count_kernel      kept rows per 4096-row tile
//   2. offsets_kernel    exclusive scan of the tile counts (one block)
//   3. scatter_kernel    block scan of the keep flags, scatter rows < cap
//   4. zero_tail_kernel  zero rows [min(count, cap), cap)
// Each thread owns kItems CONSECUTIVE rows, so a thread's exclusive prefix
// plus its running count is the row's output slot: order is preserved.
#include "compact_scan.cuh"

namespace {

constexpr int kMaxChannels = 8;

struct Channels {
  const int* in[kMaxChannels];
  int* out[kMaxChannels];
};

__global__ void scatter_kernel(const unsigned char* __restrict__ keep,
                               long long n,
                               const int* __restrict__ tile_offsets,
                               Channels ch, int nchan, long long cap) {
  __shared__ int warp_sums[kThreads / 32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool k[kItems];
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    k[j] = i < n && keep[i] != 0;
    c += k[j];
  }
  int total;
  long long pos = tile_offsets[blockIdx.x] +
                  block_exclusive_sum<kThreads>(c, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!k[j]) continue;
    if (pos < cap) {
      for (int q = 0; q < nchan; ++q) ch.out[q][pos] = ch.in[q][base + j];
    }
    ++pos;
  }
}

__global__ void zero_tail_kernel(const int* __restrict__ count, Channels ch,
                                 int nchan, long long cap) {
  const long long cnt = *count;
  const long long first = cnt < cap ? cnt : cap;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    for (int q = 0; q < nchan; ++q) ch.out[q][i] = 0;
  }
}

}  // namespace

// int32 words of scratch pch_compact_rows needs for n rows.
PCH_API long long pch_compact_rows_scratch(long long n) {
  return pch::blocks_for(n, kTile) + 1;
}

PCH_API int pch_max_channels() { return kMaxChannels; }

// keep: uint8[n] (a torch.bool tensor); in/out: host arrays of nchan device
// pointers to int32[n] / int32[cap]; scratch: int32[pch_compact_rows_scratch(n)],
// whose last word receives the true kept count.
PCH_API int pch_compact_rows(const unsigned char* keep, long long n,
                             const void* const* in, void* const* out,
                             int nchan, long long cap, int* scratch,
                             void* stream) {
  if (nchan < 0 || nchan > kMaxChannels || n < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Channels ch{};
  for (int q = 0; q < nchan; ++q) {
    ch.in[q] = static_cast<const int*>(in[q]);
    ch.out[q] = static_cast<int*>(out[q]);
  }
  const int nb = pch::blocks_for(n, kTile);
  int* tile = scratch;
  int* count = scratch + nb;
  if (nb > 0) count_kernel<<<nb, kThreads, 0, s>>>(keep, n, tile);
  offsets_kernel<<<1, kScanThreads, 0, s>>>(tile, nb, count);
  if (nb > 0)
    scatter_kernel<<<nb, kThreads, 0, s>>>(keep, n, tile, ch, nchan, cap);
  if (cap > 0) {
    int grid = pch::blocks_for(cap, 256);
    if (grid > 2048) grid = 2048;
    zero_tail_kernel<<<grid, 256, 0, s>>>(count, ch, nchan, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
