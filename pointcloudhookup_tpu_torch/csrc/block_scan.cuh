// Block-wide exclusive sum, shared by the compaction kernels
// (compactrows.cu, and compactidx.cu through compact_scan.cuh) and by
// winsort.cu's rank count.
#pragma once

#include "common.cuh"

namespace {

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

}  // namespace
