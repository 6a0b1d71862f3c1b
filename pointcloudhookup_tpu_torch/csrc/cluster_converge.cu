// Cell-graph DBSCAN: population, core rule, min-label components, border
// adoption.
//
// Replaces pointcloudhookup_tpu/ops/pallas/cluster_converge.py::cluster_cells
// (pallas_call at :364), with the semantics of cluster_cells_reference:
//   pop[i]  = sum of ccount over alive eps-neighbors (0 where |x_i| >= 1e37)
//   core    = alive & pop >= min_points
//   labels  = on core cells the minimum labels0 over their core component
//             (the fixpoint of the reference's min-label rounds); border
//             cells take the minimum core-neighbor label; everything else
//             is M.
//
// Bound: the pair evaluations the inputs need (~9 FP32 operations a pair
// within eps).  The TPU kernel kept the table in VMEM and swept
// Gauss-Seidel rounds inside one invocation; the rounds' count grows with
// a component's graph diameter.  Here a fixed sequence of six launches
// and no host synchronisation does the work, each pair pass culled as in
// eps_ball.cuh:
//   1. the row boxes and the boxes of the alive columns;
//   2. pop over the alive columns, with the |x| rule, the core flags and
//      the union-find's parent[i] = i;
//   2b. the boxes of the core cells;
//   3. union: the core pairs within eps, each once (j < i), of a row
//      subtile and a column subtile form components in a warp's registers,
//      and each row and column joins its component's lowest column: the
//      larger root hooks under the smaller with atomicCAS, finds halving
//      their paths (the ECL-CC scheme of Jaiganesh and Burtscher);
//   4. compress: root[i] = find(i), and atomicMin of labels0[i] into
//      compmin[root[i]] for every core row;
//   5. the border pass (lmin over the core columns, a column's label being
//      compmin[root[j]]) and the output.
// The fixpoint of the rounds is, on each core row with a self-pair (any
// finite row when eps2 >= 0), the minimum of labels0 over its connected
// component of the core graph; a core row without one (a non-finite
// coordinate) has no neighbor at all and keeps min(labels0[i], M).  The
// union-find computes exactly that, so no truncated flood is offered.
// Every caller's weights are integer counts or ones: pop is exact in any
// summation order.
#include <climits>

#include "eps_ball.cuh"

namespace {

// The root of x, halving the path on the way (parent[x] <= x throughout,
// so a path only descends).  Halving writes race benignly: every value
// written is an ancestor.
__device__ __forceinline__ int find_root(int* parent, int x) {
  volatile int* p = parent;
  int cur = p[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = p[cur])) {
      p[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// Joins the sets of a and b.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  int ra = find_root(parent, a), rb = find_root(parent, b);
  while (ra != rb) {
    if (ra > rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    const int old = atomicCAS(parent + rb, rb, ra);
    if (old == rb) break;
    rb = old;  // rb was hooked meanwhile: go on from its new parent
  }
}

__global__ void __launch_bounds__(pch::kBlockThreads)
pop_kernel(const float* __restrict__ xyz, const float* __restrict__ ccount,
           const unsigned char* __restrict__ alive, long long m,
           const float* __restrict__ eps2p, float min_points,
           const float* __restrict__ rowbox,
           const float* __restrict__ alivebox,
           float* __restrict__ pop_out, unsigned char* __restrict__ core_out,
           int* __restrict__ parent, int* __restrict__ compmin) {
  pch::reduce_rows<true, false>(
      xyz, alive, ccount, pch::DirectLabels{nullptr}, m, rowbox, alivebox,
      __ldg(eps2p), 0, [&](const pch::Rows& R, float p, int) {
        if (R.valid) {
          if (!(fabsf(R.rx) < 1e37f)) p = 0.f;
          pop_out[R.i] = p;
          core_out[R.i] = alive[R.i] != 0 && p >= min_points;
          parent[R.i] = static_cast<int>(R.i);
          compmin[R.i] = INT_MAX;
        }
      });
}

// Rows and columns are both the core cells: their boxes serve both sides.
__global__ void __launch_bounds__(pch::kBlockThreads)
union_kernel(const float* __restrict__ xyz,
             const unsigned char* __restrict__ core, long long m,
             const float* __restrict__ eps2p,
             const float* __restrict__ corebox, int* parent) {
  const pch::Rows R = pch::load_rows(xyz, m, corebox);
  const float eps2 = __ldg(eps2p);
  const bool rcore = R.valid && core[R.i] != 0;
  // each pair once, as j < i
  pch::for_near(R, corebox, m, eps2, true, [&](long long cs) {
    float cx, cy, cz;
    const bool a = pch::load_column(R, xyz, core, m, cs, eps2, cx, cy, cz);
    unsigned mask = __ballot_sync(pch::kFullMask, a);
    // the lane's pairs as a mask of the subtile's columns
    unsigned hits = 0;
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const float bx = __shfl_sync(pch::kFullMask, cx, l);
      const float by = __shfl_sync(pch::kFullMask, cy, l);
      const float bz = __shfl_sync(pch::kFullMask, cz, l);
      if (rcore && cs * pch::kSub + l < R.i &&
          pch::dist2(R.rx, R.ry, R.rz, bx, by, bz) <= eps2) {
        hits |= 1u << l;
      }
    }
    // The components of these 32 x 32 pairs, in registers: a row's mask
    // grows by every row mask it meets until none grows.  Then each row
    // and each column of a component joins the component's lowest column:
    // two unions a lane at most, where one per pair would chain a dozen
    // union-find walks one after the other.
    unsigned comp = hits;
    for (bool grew = true; __any_sync(pch::kFullMask, grew);) {
      unsigned next = comp;
      for (int k = 0; k < pch::kSub; ++k) {
        const unsigned other = __shfl_sync(pch::kFullMask, comp, k);
        if (other & comp) next |= other;
      }
      grew = next != comp;
      comp = next;
    }
    const int lane = threadIdx.x & 31;
    unsigned col_comp = 0;  // the component of column `lane`
    for (int k = 0; k < pch::kSub; ++k) {
      const unsigned other = __shfl_sync(pch::kFullMask, comp, k);
      if ((other >> lane) & 1u) col_comp = other;
    }
    const int base = static_cast<int>(cs * pch::kSub);
    if (hits) unite(parent, static_cast<int>(R.i), base + __ffs(comp) - 1);
    if (col_comp && __ffs(col_comp) - 1 != lane) {
      unite(parent, base + lane, base + __ffs(col_comp) - 1);
    }
  });
}

__global__ void compress_kernel(const unsigned char* __restrict__ core,
                                const int* __restrict__ labels0, long long m,
                                int* parent, int* __restrict__ root,
                                int* __restrict__ compmin) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < m && core[i] != 0) {
    const int r = find_root(parent, static_cast<int>(i));
    root[i] = r;
    atomicMin(compmin + r, labels0[i]);
  }
}

// A core column's final label.
struct RootLabels {
  const int* __restrict__ root;
  const int* __restrict__ compmin;
  __device__ int operator()(long long j) const { return compmin[root[j]]; }
};

__global__ void __launch_bounds__(pch::kBlockThreads)
border_kernel(const float* __restrict__ xyz,
              const unsigned char* __restrict__ core,
              const unsigned char* __restrict__ alive,
              const int* __restrict__ labels0, long long m,
              const float* __restrict__ eps2p,
              const float* __restrict__ rowbox,
              const float* __restrict__ corebox,
              const int* __restrict__ root, const int* __restrict__ compmin,
              int* __restrict__ labels_out) {
  const float eps2 = __ldg(eps2p);
  const int none = static_cast<int>(m);
  pch::reduce_rows<false, true>(
      xyz, core, nullptr, RootLabels{root, compmin}, m, rowbox, corebox,
      eps2, none, [&](const pch::Rows& R, float, int lm) {
        if (!R.valid) return;
        int out;
        if (core[R.i] != 0) {
          const bool self = pch::dist2(R.rx, R.ry, R.rz, R.rx, R.ry, R.rz) <= eps2;
          const int l0 = labels0[R.i];
          out = self ? compmin[root[R.i]] : (l0 < none ? l0 : none);
        } else {
          out = alive[R.i] != 0 ? lm : none;
        }
        labels_out[R.i] = out;
      });
}

struct Scratch {
  float *rowbox, *alivebox, *corebox;
  int *parent, *root, *compmin;
  unsigned char* core;
};

Scratch carve(void* base, long long m) {
  const long long nb = pch::box_floats(m);
  Scratch s;
  s.rowbox = static_cast<float*>(base);
  s.alivebox = s.rowbox + nb;
  s.corebox = s.alivebox + nb;
  s.parent = reinterpret_cast<int*>(s.corebox + nb);
  s.root = s.parent + m;
  s.compmin = s.root + m;
  s.core = reinterpret_cast<unsigned char*>(s.compmin + m);
  return s;
}

}  // namespace

// Scratch bytes for m rows: three box arrays, parent, root, compmin and
// the core flags.
PCH_API long long pch_cluster_cells_scratch(long long m) {
  return 3 * pch::box_floats(m) * static_cast<long long>(sizeof(float)) +
         3 * m * static_cast<long long>(sizeof(int)) + m;
}

// xyz: float32[m, 3]; ccount: float32[m]; alive: uint8[m]; labels0:
// int32[m]; eps2: float32[1] on the device; scratch:
// pch_cluster_cells_scratch(m) bytes.  Outputs pop float32[m] and labels
// int32[m].  Six launches on the stream, no synchronisation.
PCH_API int pch_cluster_cells(const float* xyz, const float* ccount,
                              const unsigned char* alive, const int* labels0,
                              long long m, const float* eps2, float min_points,
                              void* scratch, float* pop, int* labels,
                              void* stream) {
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, m);
  const int grid = static_cast<int>(pch::subtiles(m));  // a block a row subtile
  const int t = pch::kBlockThreads;
  cudaError_t e = pch::launch_boxes(xyz, alive, m, s.rowbox, s.alivebox, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  pop_kernel<<<grid, t, 0, st>>>(xyz, ccount, alive, m, eps2, min_points,
                                 s.rowbox, s.alivebox, pop, s.core,
                                 s.parent, s.compmin);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  e = pch::launch_boxes(xyz, s.core, m, nullptr, s.corebox, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  union_kernel<<<grid, t, 0, st>>>(xyz, s.core, m, eps2, s.corebox, s.parent);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  compress_kernel<<<pch::blocks_for(m, t), t, 0, st>>>(s.core, labels0, m,
                                                       s.parent, s.root, s.compmin);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  border_kernel<<<grid, t, 0, st>>>(xyz, s.core, alive, labels0, m, eps2,
                                    s.rowbox, s.corebox, s.root, s.compmin,
                                    labels);
  return static_cast<int>(cudaGetLastError());
}
