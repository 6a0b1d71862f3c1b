// Fused eps-neighborhood population + min-label reduction.
//
// Replaces pointcloudhookup_tpu/ops/pallas/neighbor.py::neighbor_reduce
// (pallas_call at :219):
//   pop[i]  = sum_j [d2(i,j) <= eps2 & allowed_j] * w_j
//   lmin[i] = min_j [d2(i,j) <= eps2 & allowed_j] ? label_j : sentinel
// with modes 0 "both", 1 "pop", 2 "lmin" (a skipped output holds its
// identity: zeros / sentinel).
//
// Bound: the O(M^2) pair evaluations (~10 FP32/integer instructions each);
// memory traffic is O(M) per row block because columns are staged through
// shared memory (eps_ball.cuh).  The TPU kernel culled with 256-row x
// 256-column AABB near-lists built in XLA; this first version culls only
// whole column tiles with no allowed column, which removes the dead
// capacity of the dense-cell table and, in the border pass (allowed =
// core), nearly every tile.  AABB culling is later work.
#include "eps_ball.cuh"

namespace {

template <bool POP, bool LMIN>
__global__ void neighbor_kernel(const float* __restrict__ xyz,
                                const int* __restrict__ labels,
                                const float* __restrict__ w,
                                const unsigned char* __restrict__ allowed,
                                long long m, float eps2, int sentinel,
                                float* __restrict__ pop_out,
                                int* __restrict__ lmin_out) {
  float p;
  int l;
  pch::eps_ball_row<POP, LMIN>(xyz, allowed, w, labels, m, eps2, sentinel, &p,
                               &l);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m) {
    pop_out[i] = POP ? p : 0.f;
    lmin_out[i] = LMIN ? l : sentinel;
  }
}

}  // namespace

// xyz: float32[m, 3]; labels: int32[m]; weights: float32[m];
// allowed: uint8[m]; outputs pop float32[m], lmin int32[m].
PCH_API int pch_neighbor_reduce(const float* xyz, const int* labels,
                                const float* weights,
                                const unsigned char* allowed, long long m,
                                float eps2, int sentinel, int mode,
                                float* pop, int* lmin, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = pch::blocks_for(m, pch::kBallThreads);
  const int t = pch::kBallThreads;
  switch (mode) {
    case 0:
      neighbor_kernel<true, true><<<grid, t, 0, s>>>(
          xyz, labels, weights, allowed, m, eps2, sentinel, pop, lmin);
      break;
    case 1:
      neighbor_kernel<true, false><<<grid, t, 0, s>>>(
          xyz, labels, weights, allowed, m, eps2, sentinel, pop, lmin);
      break;
    case 2:
      neighbor_kernel<false, true><<<grid, t, 0, s>>>(
          xyz, labels, weights, allowed, m, eps2, sentinel, pop, lmin);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
