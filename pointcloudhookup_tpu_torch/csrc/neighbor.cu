// Fused eps-neighborhood population + min-label reduction.
//
// Replaces pointcloudhookup_tpu/ops/pallas/neighbor.py::neighbor_reduce
// (pallas_call at :219):
//   pop[i]  = sum_j [d2(i,j) <= eps2 & allowed_j] * w_j
//   lmin[i] = min_j [d2(i,j) <= eps2 & allowed_j] ? label_j : sentinel
// with modes 0 "both", 1 "pop", 2 "lmin" (a skipped output holds its
// identity: zeros / sentinel).
//
// Bound: the pair evaluations the inputs need (~9 FP32 operations a pair
// within eps); the table is at most ~1 MB and stays in L2.  Two launches:
// the subtile boxes, then the culled pass of eps_ball.cuh, so a row only
// meets the column subtiles whose box lies within eps of its own 32-row
// box -- about 11 of the 2,048 at the exact path's 65,536 rows.  The TPU
// kernel culled with 256-row x 256-column near-lists built in XLA; here
// the subtiles are one warp, a block takes one row subtile, and its near
// list is built in shared memory from the supertile boxes down.  Every
// caller's weights are integer counts or ones, so pop is exact whatever
// order the partial sums meet in.
#include "eps_ball.cuh"

namespace {

template <bool POP, bool LMIN>
__global__ void __launch_bounds__(pch::kBlockThreads)
neighbor_kernel(const float* __restrict__ xyz, const int* __restrict__ labels,
                const float* __restrict__ w,
                const unsigned char* __restrict__ allowed, long long m,
                const float* __restrict__ eps2p, int sentinel,
                const float* __restrict__ rowbox,
                const float* __restrict__ colbox,
                float* __restrict__ pop_out, int* __restrict__ lmin_out) {
  pch::reduce_rows<POP, LMIN>(
      xyz, allowed, w, pch::DirectLabels{labels}, m, rowbox, colbox,
      __ldg(eps2p), sentinel, [&](const pch::Rows& R, float p, int lm) {
        if (R.valid) {
          pop_out[R.i] = POP ? p : 0.f;
          lmin_out[R.i] = LMIN ? lm : sentinel;
        }
      });
}

template <bool POP, bool LMIN>
cudaError_t launch(const float* xyz, const int* labels, const float* w,
                   const unsigned char* allowed, long long m,
                   const float* eps2, int sentinel, float* boxes, float* pop,
                   int* lmin, cudaStream_t s) {
  neighbor_kernel<POP, LMIN>
      <<<static_cast<int>(pch::subtiles(m)), pch::kBlockThreads, 0, s>>>(
          xyz, labels, w, allowed, m, eps2, sentinel, boxes, boxes + pch::box_floats(m),
          pop, lmin);
  return cudaGetLastError();
}

}  // namespace

// Scratch bytes for m rows: the row and column box sets.
PCH_API long long pch_neighbor_scratch(long long m) {
  return 2 * pch::box_floats(m) * static_cast<long long>(sizeof(float));
}

// xyz: float32[m, 3]; labels: int32[m]; weights: float32[m];
// allowed: uint8[m]; eps2: float32[1] on the device; scratch:
// pch_neighbor_scratch(m) bytes; outputs pop float32[m], lmin int32[m].
PCH_API int pch_neighbor_reduce(const float* xyz, const int* labels,
                                const float* weights,
                                const unsigned char* allowed, long long m,
                                const float* eps2, int sentinel, int mode,
                                void* scratch, float* pop, int* lmin,
                                void* stream) {
  if (m < 0 || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* boxes = static_cast<float*>(scratch);
  cudaError_t e =
      pch::launch_boxes(xyz, allowed, m, boxes, boxes + pch::box_floats(m), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (mode) {
    case 0:
      e = launch<true, true>(xyz, labels, weights, allowed, m, eps2, sentinel,
                             boxes, pop, lmin, s);
      break;
    case 1:
      e = launch<true, false>(xyz, labels, weights, allowed, m, eps2, sentinel,
                              boxes, pop, lmin, s);
      break;
    default:
      e = launch<false, true>(xyz, labels, weights, allowed, m, eps2, sentinel,
                              boxes, pop, lmin, s);
  }
  return static_cast<int>(e);
}
