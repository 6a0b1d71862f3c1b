// Count and tile-offset passes shared by the order-preserving compaction
// kernels (compactrows.cu, compactidx.cu).
//
// Rows are cut into kTile = kThreads * kItems row tiles, one block each;
// each thread owns kItems CONSECUTIVE rows, so a thread's exclusive prefix
// plus its running count is a kept row's output slot and order is kept:
//   count_kernel    kept rows per tile
//   offsets_kernel  exclusive scan of the tile counts (one block); the
//                   total lands in *count
// The including file then scans each tile again and emits.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 4096 rows per block
constexpr int kScanThreads = 1024;

// Exclusive block-wide sum of one int per thread.  warp_sums is shared
// scratch of THREADS / 32 ints; *total receives the block's sum.  Safe to
// call repeatedly in a loop (it synchronizes before reusing warp_sums).
template <int THREADS>
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(pch::kFullMask, incl, d);
    if (lane >= d) incl += up;
  }
  __syncthreads();  // earlier readers of warp_sums are done
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(pch::kFullMask, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  const int warp_prefix = warp > 0 ? warp_sums[warp - 1] : 0;
  return warp_prefix + incl - v;
}

__global__ void count_kernel(const unsigned char* __restrict__ keep,
                             long long n, int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kThreads / 32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i < n && keep[i] != 0) ++c;
  }
  int total;
  block_exclusive_sum<kThreads>(c, warp_sums, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// In place: tile_counts[b] <- sum of tile_counts[0..b); *count <- the sum.
__global__ void offsets_kernel(int* __restrict__ tile_counts, int nb,
                               int* __restrict__ count) {
  __shared__ int warp_sums[kScanThreads / 32];
  int carry = 0;  // identical in every thread
  for (int start = 0; start < nb; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int v = i < nb ? tile_counts[i] : 0;
    int total;
    const int excl = block_exclusive_sum<kScanThreads>(v, warp_sums, &total);
    if (i < nb) tile_counts[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry;
}

}  // namespace
