// Shared helpers for the port's CUDA kernels.
//
// Every kernel file exposes plain C entry points (loaded with ctypes by
// pointcloudhookup_tpu_torch/ops/kernels/build.py).  An entry point
// launches on the stream it is given, allocates nothing (the Python
// wrapper passes outputs and scratch), and returns cudaGetLastError().
//
// All sources build with --fmad=false: the JAX reference rounds every
// product and sum separately, and a contracted a*b+c can flip borderline
// comparisons such as d2 <= eps2.  The distance arithmetic below also
// spells the rounding out with the _rn intrinsics.
#pragma once

#include <cuda_runtime.h>

#define PCH_API extern "C" __attribute__((visibility("default")))

namespace pch {

constexpr unsigned kFullMask = 0xffffffffu;

inline int blocks_for(long long n, long long per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

// Squared distance from coordinate DIFFERENCES, ((dx*dx + dy*dy) + dz*dz),
// each step rounded to nearest: the order of neighbor_reduce_reference.
__device__ __forceinline__ float dist2(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace pch
