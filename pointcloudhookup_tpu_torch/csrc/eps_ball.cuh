// The pairwise eps-ball tile pass shared by neighbor.cu and
// cluster_converge.cu.
//
// One thread owns one row i and walks every column j in tiles of
// kBallThreads staged in shared memory, reducing over the columns with
// d2(i, j) <= eps2 and allowed[j]:
//   pop  = sum of w[j]                  (POP)
//   lmin = min of labels[j], sentinel   (LMIN)
// d2 comes from coordinate differences (pch::dist2).  A tile with no
// allowed column is skipped as a whole: dead capacity at the end of the
// dense-cell table, and the non-core cells of a border pass, cost one
// barrier per tile instead of a pass over its pairs.  Columns are summed in
// ascending order; the path's weights are integer counts, so pop is exact.
#pragma once

#include "common.cuh"

namespace pch {

constexpr int kBallThreads = 256;

template <bool POP, bool LMIN>
__device__ __forceinline__ void eps_ball_row(
    const float* __restrict__ xyz, const unsigned char* __restrict__ allowed,
    const float* __restrict__ w, const int* __restrict__ labels, long long m,
    float eps2, int sentinel, float* pop, int* lmin) {
  __shared__ float sx[kBallThreads];
  __shared__ float sy[kBallThreads];
  __shared__ float sz[kBallThreads];
  __shared__ float sw[kBallThreads];
  __shared__ int sl[kBallThreads];
  __shared__ unsigned char sa[kBallThreads];
  const int t = threadIdx.x;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + t;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  if (i < m) {
    rx = xyz[3 * i];
    ry = xyz[3 * i + 1];
    rz = xyz[3 * i + 2];
  }
  float p = 0.f;
  int lm = sentinel;
  for (long long t0 = 0; t0 < m; t0 += kBallThreads) {
    const long long j = t0 + t;
    int a = 0;
    if (j < m) {
      a = allowed[j] != 0;
      sx[t] = xyz[3 * j];
      sy[t] = xyz[3 * j + 1];
      sz[t] = xyz[3 * j + 2];
      if (POP) sw[t] = w[j];
      if (LMIN) sl[t] = labels[j];
    }
    sa[t] = static_cast<unsigned char>(a);
    if (__syncthreads_or(a)) {
      const long long rest = m - t0;
      const int len = rest < kBallThreads ? static_cast<int>(rest) : kBallThreads;
      for (int k = 0; k < len; ++k) {
        if (sa[k] && dist2(rx, ry, rz, sx[k], sy[k], sz[k]) <= eps2) {
          if (POP) p = __fadd_rn(p, sw[k]);
          if (LMIN) lm = sl[k] < lm ? sl[k] : lm;
        }
      }
    }
    __syncthreads();
  }
  *pop = p;
  *lmin = lm;
}

}  // namespace pch
