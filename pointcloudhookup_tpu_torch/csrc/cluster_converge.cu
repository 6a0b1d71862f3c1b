// Cell-graph DBSCAN: population, core rule, min-label fixpoint, border
// adoption.
//
// Replaces pointcloudhookup_tpu/ops/pallas/cluster_converge.py::cluster_cells
// (pallas_call at :364), with the semantics of cluster_cells_reference:
//   pop[i]  = sum of ccount over alive eps-neighbors (0 where |x_i| >= 1e37)
//   core    = alive & pop >= min_points
//   labels  = labels0 on core cells, flooded to the minimum over each core
//             component; border cells take the minimum core-neighbor
//             label; everything else is M.
//
// Bound: the pairwise pass (eps_ball.cuh), once for pop, once per round
// and once for the border.  The TPU kernel kept the whole table in VMEM
// and looped inside one invocation; here each phase is one launch:
//   pch_cluster_pop     pop, core flags and the seed labels
//   pch_cluster_round   one Jacobi round cur_in -> cur_out, raising a
//                       device flag when any label changed
//   pch_cluster_border  final labels
// and the caller loops over rounds until the flag stays clear (at most M
// rounds).  The fixpoint does not depend on the order of updates, so
// Jacobi rounds reach exactly the labels the Gauss-Seidel TPU sweep does;
// on the path's core tables a round costs one small launch.
#include "eps_ball.cuh"

namespace {

__global__ void pop_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ ccount,
                           const unsigned char* __restrict__ alive,
                           const int* __restrict__ labels0, long long m,
                           float eps2, float min_points,
                           float* __restrict__ pop_out,
                           unsigned char* __restrict__ core_out,
                           int* __restrict__ cur_out) {
  float p;
  int unused;
  pch::eps_ball_row<true, false>(xyz, alive, ccount, nullptr, m, eps2, 0, &p,
                                 &unused);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m) {
    if (!(fabsf(xyz[3 * i]) < 1e37f)) p = 0.f;
    const bool core = alive[i] != 0 && p >= min_points;
    pop_out[i] = p;
    core_out[i] = core;
    cur_out[i] = core ? labels0[i] : static_cast<int>(m);
  }
}

__global__ void round_kernel(const float* __restrict__ xyz,
                             const unsigned char* __restrict__ core,
                             const int* __restrict__ cur_in, long long m,
                             float eps2, int* __restrict__ cur_out,
                             int* __restrict__ changed) {
  float unused;
  int lm;
  pch::eps_ball_row<false, true>(xyz, core, nullptr, cur_in, m, eps2,
                                 static_cast<int>(m), &unused, &lm);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m) {
    const int old = cur_in[i];
    const int nw = (core[i] != 0 && lm < old) ? lm : old;
    cur_out[i] = nw;
    if (nw != old) *changed = 1;
  }
}

__global__ void border_kernel(const float* __restrict__ xyz,
                              const unsigned char* __restrict__ core,
                              const unsigned char* __restrict__ alive,
                              const int* __restrict__ cur, long long m,
                              float eps2, int* __restrict__ labels_out) {
  float unused;
  int lm;
  pch::eps_ball_row<false, true>(xyz, core, nullptr, cur, m, eps2,
                                 static_cast<int>(m), &unused, &lm);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m) {
    labels_out[i] =
        core[i] != 0 ? cur[i] : (alive[i] != 0 ? lm : static_cast<int>(m));
  }
}

}  // namespace

// xyz: float32[m, 3]; ccount: float32[m]; alive: uint8[m]; labels0: int32[m].
// Outputs pop float32[m], core uint8[m], cur int32[m] (the round-0 labels).
PCH_API int pch_cluster_pop(const float* xyz, const float* ccount,
                            const unsigned char* alive, const int* labels0,
                            long long m, float eps2, float min_points,
                            float* pop, unsigned char* core, int* cur,
                            void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pop_kernel<<<pch::blocks_for(m, pch::kBallThreads), pch::kBallThreads, 0,
               s>>>(xyz, ccount, alive, labels0, m, eps2, min_points, pop,
                    core, cur);
  return static_cast<int>(cudaGetLastError());
}

// One Jacobi round; *changed (int32, device) is cleared first and set to 1
// when any label moved.
PCH_API int pch_cluster_round(const float* xyz, const unsigned char* core,
                              const int* cur_in, long long m, float eps2,
                              int* cur_out, int* changed, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  round_kernel<<<pch::blocks_for(m, pch::kBallThreads), pch::kBallThreads, 0,
                 s>>>(xyz, core, cur_in, m, eps2, cur_out, changed);
  return static_cast<int>(cudaGetLastError());
}

PCH_API int pch_cluster_border(const float* xyz, const unsigned char* core,
                               const unsigned char* alive, const int* cur,
                               long long m, float eps2, int* labels,
                               void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  border_kernel<<<pch::blocks_for(m, pch::kBallThreads), pch::kBallThreads, 0,
                  s>>>(xyz, core, alive, cur, m, eps2, labels);
  return static_cast<int>(cudaGetLastError());
}
