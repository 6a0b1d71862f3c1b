// Count and tile-offset passes of compact_indices (compactidx.cu).
//
// Rows are cut into kTile = kThreads * kItems row tiles, one block each;
// each thread owns kItems CONSECUTIVE rows, so a thread's exclusive prefix
// plus its running count is a kept row's output slot and order is kept:
//   count_kernel    kept rows per tile
//   offsets_kernel  exclusive scan of the tile counts (one block); the
//                   total lands in *count
// The including file then scans each tile again and emits.
#pragma once

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 4096 rows per block
constexpr int kScanThreads = 1024;

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
