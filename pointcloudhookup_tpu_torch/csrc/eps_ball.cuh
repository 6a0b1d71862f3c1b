// The culled eps-ball pair pass shared by neighbor.cu and
// cluster_converge.cu.
//
// Rows and columns come in subtiles of kSub = 32 (one warp), and subtiles
// in supertiles of 32 (1,024 rows).  A prepass (boxes_kernel, one launch)
// writes, for every subtile and every supertile, the box of its rows and
// the box of its allowed columns.  A box is two: one over the near
// class (every coordinate below 1e37 in magnitude) and one over the far
// class (the rest: the dead-row coordinate 3e38, infinities), 12 floats
// (lo x, y, z, hi x, y, z for each class; an empty one is +inf / -inf).
// A subtile that holds live rows and dead ones so keeps a tight box for its
// live rows, and its dead rows meet only columns near 3e38.
//
// The main pass gives each block one row subtile, whose 32 rows every warp
// holds (a row per lane):
//   1. the block tests the column supertiles' boxes against the row box,
//      then the subtiles of the near supertiles, a warp to a supertile,
//      and lists the near subtiles in shared memory (ascending): a few
//      hundred box tests at 65,536 rows, not 2,048;
//   2. the list is dealt round the block's 16 warps; for each listed column
//      subtile a warp loads the allowed columns within eps of the row box
//      (a lane each) and runs the pairs with the columns broadcast by
//      shuffles.
// A 2,048-row table so launches 64 blocks of 16 warps, 1,024 warps in
// all, and a heavy row subtile is shared by its block's 16 warps.
//
// Culling never drops a pair the predicate dist2(i, j) <= eps2 accepts.
// The box gap on an axis is max(lo_c - hi_r, lo_r - hi_c, 0), each
// difference rounded to nearest, and the box d2 sums the gaps' squares in
// dist2's order and rounding.  Rounding is monotone, so for any row and
// column inside the boxes |fl(x_i - x_j)| >= gap and dist2 >= box d2: the
// test is exactly conservative and needs no margin.  fminf / fmaxf drop a
// NaN coordinate, which no predicate accepts anyway.
//
// The warps' partial results meet in shared memory in a fixed order, and
// the block writes each of its rows once.  The summation order is not the
// plain version's: every caller's weights are integer counts or ones, whose
// sums below 2**24 are exact in any order, so pop is identical.
#pragma once

#include "common.cuh"

namespace pch {

constexpr int kSub = 32;          // rows a subtile, and subtiles a supertile
constexpr int kBox = 12;          // floats a box: near class, far class
constexpr int kBlockWarps = 16;   // warps sharing one row subtile
constexpr int kBlockThreads = kBlockWarps * 32;
constexpr int kNearChunk = 2048;  // column subtiles listed at a time (65,536 columns)
constexpr float kFar = 1e37f;     // the far class: a coordinate at least this large

__host__ __device__ inline long long subtiles(long long m) { return (m + kSub - 1) / kSub; }

// Floats of a box set for m rows: the subtile boxes, then the supertile
// boxes from kBox * subtiles(m) on.
inline long long box_floats(long long m) {
  return kBox * (subtiles(m) + subtiles(subtiles(m)));
}

// The d2 of the gap between two 6-float boxes, in dist2's rounding.
__device__ __forceinline__ float box_d2(const float* a, const float* b) {
  float g[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    g[q] = fmaxf(fmaxf(__fsub_rn(b[q], a[q + 3]), __fsub_rn(a[q], b[q + 3])), 0.f);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

// Whether some class of box a lies within eps of some class of box b
// (12 floats each).
__device__ __forceinline__ bool box_near(const float* a, const float* b, float eps2) {
  return box_d2(a, b) <= eps2 || box_d2(a, b + 6) <= eps2 ||
         box_d2(a + 6, b) <= eps2 || box_d2(a + 6, b + 6) <= eps2;
}

__device__ __forceinline__ void load_box(const float* __restrict__ boxes,
                                         long long s, float* out) {
#pragma unroll
  for (int q = 0; q < kBox; ++q) out[q] = __ldg(boxes + kBox * s + q);
}

__device__ __forceinline__ bool box_near_at(const float* a,
                                            const float* __restrict__ boxes,
                                            long long s, float eps2) {
  float b[kBox];
  load_box(boxes, s, b);
  return box_near(a, b, eps2);
}

__device__ __forceinline__ bool is_far(float x, float y, float z) {
  return !(fabsf(x) < kFar && fabsf(y) < kFar && fabsf(z) < kFar);
}

// The union of the 32 lanes' boxes, in every lane.
__device__ __forceinline__ void warp_union(float* v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float& lo = v[6 * k + q];
        float& hi = v[6 * k + q + 3];
        lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, d));
        hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, d));
      }
    }
  }
}

// Lanes 0..11 write the box v to out.
__device__ __forceinline__ void store_box(const float* v, float* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kBox; ++q) {
    if (lane == q) out[q] = v[q];
  }
}

namespace {  // a kernel per translation unit: this header has two includers

// The prepass: per subtile the box of its rows into rowbox (unless null)
// and of its allowed columns into colbox, then per supertile the union of
// its 32 subtiles' boxes.  One warp a subtile, one block a supertile.
__global__ void __launch_bounds__(1024)
boxes_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ allowed,
             long long m, float* __restrict__ rowbox, float* __restrict__ colbox) {
  __shared__ float sub[2][kSub][kBox];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nsub = subtiles(m);
  const long long s = static_cast<long long>(blockIdx.x) * kSub + w;
  const long long i = s * kSub + lane;
  const bool in = i < m;
  float x = 0.f, y = 0.f, z = 0.f;
  if (in) {
    x = xyz[3 * i];
    y = xyz[3 * i + 1];
    z = xyz[3 * i + 2];
  }
  const float inf = __int_as_float(0x7f800000);
  const bool far = is_far(x, y, z);
  for (int k = rowbox == nullptr ? 1 : 0; k < 2; ++k) {
    const bool sel = k == 0 ? in : in && allowed[i] != 0;
    float v[kBox];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool on = sel && far == (c == 1);
      v[6 * c + 0] = on ? x : inf;
      v[6 * c + 1] = on ? y : inf;
      v[6 * c + 2] = on ? z : inf;
      v[6 * c + 3] = on ? x : -inf;
      v[6 * c + 4] = on ? y : -inf;
      v[6 * c + 5] = on ? z : -inf;
    }
    warp_union(v);
    store_box(v, sub[k][w]);
    if (s < nsub) store_box(v, (k == 0 ? rowbox : colbox) + kBox * s);
  }
  __syncthreads();
  if (w < 2 && (w == 1 || rowbox != nullptr)) {
    float v[kBox];
#pragma unroll
    for (int q = 0; q < kBox; ++q) v[q] = sub[w][lane][q];
    warp_union(v);
    store_box(v, (w == 0 ? rowbox : colbox) + kBox * (nsub + blockIdx.x));
  }
}

// rowbox may be null (columns only).
cudaError_t launch_boxes(const float* xyz, const unsigned char* allowed,
                         long long m, float* rowbox, float* colbox,
                         cudaStream_t s) {
  boxes_kernel<<<static_cast<int>(subtiles(subtiles(m))), 1024, 0, s>>>(
      xyz, allowed, m, rowbox, colbox);
  return cudaGetLastError();
}

}  // namespace

// A block's row subtile: this lane's row and the subtile's box (every
// warp of the block holds the same 32 rows).
struct Rows {
  long long rs;
  long long i;
  bool valid;  // i < m
  float rx, ry, rz;
  float box[kBox];
};

__device__ __forceinline__ Rows load_rows(const float* __restrict__ xyz, long long m,
                                          const float* __restrict__ rowbox) {
  Rows R;
  R.rs = blockIdx.x;
  R.i = R.rs * kSub + (threadIdx.x & 31);
  R.valid = R.i < m;
  R.rx = R.ry = R.rz = 0.f;
  if (R.valid) {
    R.rx = __ldg(xyz + 3 * R.i);
    R.ry = __ldg(xyz + 3 * R.i + 1);
    R.rz = __ldg(xyz + 3 * R.i + 2);
  }
  load_box(rowbox, R.rs, R.box);
  return R;
}

// Block-wide: the column subtiles in [c0, c1) (c0 a multiple of kSub, at
// most kNearChunk of them) whose box is within eps of the row box,
// ascending, into near; returns their number.  First the supertiles (two
// warps, a lane each), then the subtiles of each near supertile (a warp
// each, a lane a subtile), kBlockWarps supertiles a round.
__device__ __forceinline__ int build_near(const float* __restrict__ colbox,
                                          long long nsub, long long c0, long long c1,
                                          const Rows& R, float eps2, int* near,
                                          int* warp_sums, unsigned* sup_mask) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* __restrict__ sup = colbox + kBox * nsub;
  const long long p0 = c0 / kSub, p1 = (c1 + kSub - 1) / kSub;
  if (w < 2) {
    const long long p = p0 + w * 32 + lane;
    const bool hit = p < p1 && box_near_at(R.box, sup, p, eps2);
    const unsigned b = __ballot_sync(kFullMask, hit);
    if (lane == 0) sup_mask[w] = b;
  }
  __syncthreads();
  unsigned long long mask =
      sup_mask[0] | (static_cast<unsigned long long>(sup_mask[1]) << 32);
  int total = 0;
  while (mask) {  // the same in every thread
    unsigned long long mine = mask;
    for (int q = 0; q < w && mine; ++q) mine &= mine - 1;
    bool hit = false;
    long long c = 0;
    if (mine) {
      c = (p0 + __ffsll(static_cast<long long>(mine)) - 1) * kSub + lane;
      hit = c < c1 && box_near_at(R.box, colbox, c, eps2);
    }
    const unsigned b = __ballot_sync(kFullMask, hit);
    if (lane == 0) warp_sums[w] = __popc(b);
    __syncthreads();
    int off = total, round = 0;
#pragma unroll
    for (int q = 0; q < kBlockWarps; ++q) {
      if (q < w) off += warp_sums[q];
      round += warp_sums[q];
    }
    if (hit) near[off + __popc(b & ((1u << lane) - 1))] = static_cast<int>(c);
    total += round;
    for (int q = 0; q < kBlockWarps && mask; ++q) mask &= mask - 1;
    __syncthreads();
  }
  return total;
}

// Block-wide: fn(cs) for every column subtile cs near the block's row
// subtile (cs <= its own with `lower`), the near list dealt round the
// warps; fn runs warp-wide.
template <class Fn>
__device__ __forceinline__ void for_near(const Rows& R, const float* __restrict__ colbox,
                                         long long m, float eps2, bool lower, Fn&& fn) {
  __shared__ int near[kNearChunk];
  __shared__ int warp_sums[kBlockWarps];
  __shared__ unsigned sup_mask[2];
  const long long nsub = subtiles(m);
  const long long end = lower ? R.rs + 1 : nsub;
  for (long long c0 = 0; c0 < end; c0 += kNearChunk) {
    const long long c1 = c0 + kNearChunk < end ? c0 + kNearChunk : end;
    const int n = build_near(colbox, nsub, c0, c1, R, eps2, near, warp_sums, sup_mask);
    for (int e = threadIdx.x >> 5; e < n; e += kBlockWarps) fn(static_cast<long long>(near[e]));
    __syncthreads();  // near is rebuilt by the next chunk
  }
}

// Lane l's column of subtile cs: its coordinates, and whether it is
// allowed and within eps of the row subtile's box (a point is a box of its
// own: the same conservative test), so the pair loop skips the rest.
__device__ __forceinline__ bool load_column(const Rows& R,
                                            const float* __restrict__ xyz,
                                            const unsigned char* __restrict__ allowed,
                                            long long m, long long cs, float eps2,
                                            float& cx, float& cy, float& cz) {
  const long long j = cs * kSub + (threadIdx.x & 31);
  cx = cy = cz = 0.f;
  if (!(j < m && allowed[j] != 0)) return false;
  cx = __ldg(xyz + 3 * j);
  cy = __ldg(xyz + 3 * j + 1);
  cz = __ldg(xyz + 3 * j + 2);
  const float pt[6] = {cx, cy, cz, cx, cy, cz};
  return box_d2(pt, R.box) <= eps2 || box_d2(pt, R.box + 6) <= eps2;
}

// Labels read straight from an array (neighbor_reduce's lmin).
struct DirectLabels {
  const int* __restrict__ l;
  __device__ int operator()(long long j) const { return l[j]; }
};

// The whole reduction for one block: pop (sum of w) and lmin (min label,
// sentinel if none) over the allowed columns within eps of each row of the
// block's subtile; then epi(R, p, lm), warp-wide, on warp 0.  The warps'
// partial results are combined in a fixed order.
template <bool POP, bool LMIN, class Labels, class Epi>
__device__ __forceinline__ void reduce_rows(
    const float* __restrict__ xyz, const unsigned char* __restrict__ allowed,
    const float* __restrict__ w, Labels labels, long long m,
    const float* __restrict__ rowbox, const float* __restrict__ colbox,
    float eps2, int sentinel, Epi epi) {
  __shared__ float part_p[kBlockWarps][kSub];
  __shared__ int part_l[kBlockWarps][kSub];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Rows R = load_rows(xyz, m, rowbox);
  float p = 0.f;
  int lm = sentinel;
  for_near(R, colbox, m, eps2, false, [&](long long cs) {
    float cx, cy, cz;
    const bool a = load_column(R, xyz, allowed, m, cs, eps2, cx, cy, cz);
    unsigned mask = __ballot_sync(kFullMask, a);
    const long long j = cs * kSub + lane;
    float cw = 0.f;
    int cl = 0;
    if (a) {
      if (POP) cw = __ldg(w + j);
      if (LMIN) cl = labels(j);
    }
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const float bx = __shfl_sync(kFullMask, cx, l);
      const float by = __shfl_sync(kFullMask, cy, l);
      const float bz = __shfl_sync(kFullMask, cz, l);
      const float bw = POP ? __shfl_sync(kFullMask, cw, l) : 0.f;
      const int bl = LMIN ? __shfl_sync(kFullMask, cl, l) : 0;
      if (dist2(R.rx, R.ry, R.rz, bx, by, bz) <= eps2) {
        if (POP) p = __fadd_rn(p, bw);
        if (LMIN) lm = bl < lm ? bl : lm;
      }
    }
  });
  part_p[warp][lane] = p;
  part_l[warp][lane] = lm;
  __syncthreads();
  if (warp == 0) {
    for (int q = 1; q < kBlockWarps; ++q) {
      if (POP) p = __fadd_rn(p, part_p[q][lane]);
      if (LMIN) lm = part_l[q][lane] < lm ? part_l[q][lane] : lm;
    }
    epi(R, p, lm);
  }
}

}  // namespace pch
