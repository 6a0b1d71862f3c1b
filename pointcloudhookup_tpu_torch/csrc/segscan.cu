// Segmented inclusive scan (add / max / min over int32 or float32) of one
// column [n], or of C <= 4 columns [n, C] (row-major) under one flag array.
//
// Replaces pointcloudhookup_tpu/ops/pallas/segscan.py::segmented_scan_pallas
// (pallas_call at :136).  Forward scans restart at rows whose flag is set;
// reverse scans run from the end and restart at segment ENDS, i.e. the
// reversed flags are is_start[i+1] with the last row always flagged
// (pointcloudhookup_tpu/ops/segments.py:95-99).  The first row a scan
// reaches is always flagged, so no identity value is ever folded into a
// result.  The combine rule is segscan.py's right-dominant one,
//   (fa, va) . (fb, vb) = (fa | fb, fb ? vb : op(va, vb)).
//
// Bound: device-memory bandwidth: the values and flags read once and the
// outputs written once (9 bytes a row for one column).  The TPU kernel
// carried the running state through its sequential grid in SMEM; here one
// kernel scans in one pass by the decoupled look-back:
//   - a block takes the next tile, in scan order, from an atomic counter:
//     a reverse scan takes the array's tiles from the end, so loads stay
//     aligned to the array and the ragged tile is scanned first (its rows
//     past n precede row n - 1, which is flagged);
//   - each of its 256 threads owns consecutive rows (thread order is scan
//     order), 16 for one column (4,096-row tiles), 8 for two, 4 for three
//     or four: 64 bytes of values in four 16-byte loads (three for C = 3),
//     the flags in one load; a reverse scan takes the flag byte after its
//     rows from the neighbouring lane by a shuffle, with one byte load at
//     warp and tile edges;
//   - the thread scans its rows in registers, the warp scans the threads'
//     (flag, value) states by shuffles, warp 0 the warps' through shared
//     memory; the block publishes its tile's aggregate, warp 0 folds the
//     predecessors' words into the carry (seg_look_back in lookback.cuh: a
//     fixed fold, so float sums do not depend on timing), and the block
//     writes its rows with 16-byte stores.
// A base pointer that is not 16-byte aligned takes the same kernel with
// scalar loads and stores (VEC = false); so does the ragged tile.  One
// cudaMemsetAsync per call clears the tile counter and the status words.
#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;

// Rows a thread owns for C columns: 64 bytes of values, in four 16-byte
// loads (three for C = 3), and its flags in one load.
template <int C>
__host__ __device__ constexpr int items() {
  return C == 1 ? 16 : (C == 2 ? 8 : 4);
}
template <int C>
__host__ __device__ constexpr int tile_rows() {
  return kThreads * items<C>();
}

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

template <int OP>
struct Apply {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    if constexpr (OP == kAdd) {
      return a + b;
    } else if constexpr (OP == kMax) {
      return a > b ? a : b;
    } else {
      return a < b ? a : b;
    }
  }
};

// Bit j set for each nonzero byte j of w.
__device__ __forceinline__ unsigned byte_mask(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// x <- p . x, column by column (xf: x's flag).
template <typename T, int C, typename OP>
__device__ __forceinline__ void fold_into(bool& xf, T (&xv)[C], bool pf,
                                          const T (&pv)[C], OP op) {
  if (!xf) {
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = op(pv[c], xv[c]);
  }
  xf = xf || pf;
}

template <typename T, int OP, bool REV, int C, bool VEC>
__global__ void __launch_bounds__(kThreads)
    segscan_kernel(const T* __restrict__ values,
                   const unsigned char* __restrict__ is_start,
                   T* __restrict__ out, long long n, int ntiles,
                   unsigned long long* __restrict__ agg,
                   unsigned long long* __restrict__ incl,
                   unsigned* __restrict__ next_tile) {
  __shared__ int s_tile;
  __shared__ bool s_wf[kWarps];
  __shared__ T s_wv[kWarps][C];
  __shared__ bool s_cf;
  __shared__ T s_cv[C];
  const Apply<OP> op;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  constexpr int kItems = items<C>();
  constexpr int kTile = tile_rows<C>();
  const int tile = s_tile;  // in scan order
  const int atile = REV ? ntiles - 1 - tile : tile;
  const int slot = REV ? kThreads - 1 - threadIdx.x : threadIdx.x;
  const long long a0 = static_cast<long long>(atile) * kTile + slot * kItems;
  const bool full = a0 + kItems <= n;

  // ---- load: v[k] is row a0 + k (array order), bit k of m is_start[a0 + k]
  T v[kItems][C];
  unsigned m = 0;
  if (VEC && full) {
    const uint4* src = reinterpret_cast<const uint4*>(values + a0 * C);
#pragma unroll
    for (int i = 0; i < kItems * C / 4; ++i) {
      const uint4 q = src[i];
      const unsigned b[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) v[(4 * i + j) / C][(4 * i + j) % C] = from_bits<T>(b[j]);
    }
    if constexpr (kItems == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(is_start + a0);
      m = byte_mask(q.x) | byte_mask(q.y) << 4 | byte_mask(q.z) << 8 | byte_mask(q.w) << 12;
    } else if constexpr (kItems == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(is_start + a0);
      m = byte_mask(q.x) | byte_mask(q.y) << 4;
    } else {
      m = byte_mask(*reinterpret_cast<const unsigned*>(is_start + a0));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long r = a0 + k;
      const bool in = r < n;
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = in ? values[r * C + c] : T(0);
      if (in && is_start[r]) m |= 1u << k;
    }
  }
  // bit k of f: row a0 + k restarts the scan
  unsigned f;
  if (REV) {  // at is_start[a + 1]; the last row always
    const unsigned up = __shfl_up_sync(pch::kFullMask, m, 1);  // lane - 1: the rows after
    unsigned next = 1;
    if (a0 + kItems < n) next = lane > 0 ? (up & 1u) : (is_start[a0 + kItems] != 0);
    f = (m >> 1) | (next << (kItems - 1));
    const long long last = n - 1 - a0;
    if (last >= 0 && last < kItems) f |= 1u << last;
  } else {
    f = m;
    if (a0 == 0) f |= 1u;
  }

  // ---- the thread's rows, in registers, in scan order
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    const int k = REV ? kItems - 1 - j : j;
    const int kp = REV ? k + 1 : k - 1;
    if (!((f >> k) & 1u)) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = op(v[kp][c], v[k][c]);
    }
  }
  // rows before the thread's first flag, in scan order, take its prefix
  const int open = f == 0 ? kItems : (REV ? __clz(f) - (32 - kItems) : __ffs(f) - 1);
  bool xf = f != 0;  // the warp's inclusive state at this lane
  T xv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xv[c] = v[REV ? 0 : kItems - 1][c];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool uf = __shfl_up_sync(pch::kFullMask, xf, d);
    T uv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) uv[c] = __shfl_up_sync(pch::kFullMask, xv[c], d);
    if (lane >= d) fold_into(xf, xv, uf, uv, op);
  }
  bool ef = __shfl_up_sync(pch::kFullMask, xf, 1);  // lanes before this one
  T ev[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ev[c] = __shfl_up_sync(pch::kFullMask, xv[c], 1);
  if (lane == 31) {
    s_wf[warp] = xf;
#pragma unroll
    for (int c = 0; c < C; ++c) s_wv[warp][c] = xv[c];
  }
  __syncthreads();

  // ---- warp 0: the warps' inclusive states, the aggregate, the carry
  if (warp == 0) {
    bool wf = lane < kWarps && s_wf[lane];
    T wv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) wv[c] = lane < kWarps ? s_wv[lane][c] : T(0);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const bool uf = __shfl_up_sync(pch::kFullMask, wf, d);
      T uv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) uv[c] = __shfl_up_sync(pch::kFullMask, wv[c], d);
      if (lane >= d) fold_into(wf, wv, uf, uv, op);
    }
    if (lane < kWarps) {
      s_wf[lane] = wf;
#pragma unroll
      for (int c = 0; c < C; ++c) s_wv[lane][c] = wv[c];
    }
    bool af = __shfl_sync(pch::kFullMask, wf, kWarps - 1);
    T av[C];
#pragma unroll
    for (int c = 0; c < C; ++c) av[c] = __shfl_sync(pch::kFullMask, wv[c], kWarps - 1);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) publish(agg + static_cast<long long>(tile) * C + c, seg_word(af, av[c]));
    }
    bool cf = false;
    T cv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cv[c] = T(0);
    if (tile > 0) {
      cf = seg_look_back<T, C>(agg, incl, tile, cv, op);
      if ((tile & 31) == 31 && lane == 0) {  // an anchor: its inclusive state
        fold_into(af, av, cf, cv, op);
#pragma unroll
        for (int c = 0; c < C; ++c)
          publish(incl + static_cast<long long>(tile >> 5) * C + c, seg_word(af, av[c]));
      }
    }
    if (lane == 0) {
      s_cf = cf;
#pragma unroll
      for (int c = 0; c < C; ++c) s_cv[c] = cv[c];
    }
  }
  __syncthreads();

  // ---- the thread's exclusive prefix: carry . warps before . lanes before
  bool pf = s_cf;
  T pv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pv[c] = s_cv[c];
  if (warp > 0) {
    bool wf = s_wf[warp - 1];
    T wv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) wv[c] = s_wv[warp - 1][c];
    fold_into(wf, wv, pf, pv, op);
    pf = wf;
#pragma unroll
    for (int c = 0; c < C; ++c) pv[c] = wv[c];
  }
  if (lane > 0) {
    fold_into(ef, ev, pf, pv, op);
#pragma unroll
    for (int c = 0; c < C; ++c) pv[c] = ev[c];
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = REV ? kItems - 1 - j : j;
    if (j < open) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = op(pv[c], v[k][c]);
    }
  }

  // ---- store, in array order
  if (VEC && full) {
    uint4* dst = reinterpret_cast<uint4*>(out + a0 * C);
#pragma unroll
    for (int i = 0; i < kItems * C / 4; ++i) {
      unsigned b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_bits(v[(4 * i + j) / C][(4 * i + j) % C]);
      dst[i] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long r = a0 + k;
      if (r < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) out[r * C + c] = v[k][c];
      }
    }
  }
}

// int32 words of scratch for n rows of C columns: the tile counter (and a
// pad word), an aggregate word per tile and column, an inclusive word per
// anchor tile (one in 32) and column.
template <int C>
long long scratch_words(long long n) {
  const long long nb = pch::blocks_for(n, tile_rows<C>());
  return 2 + 2LL * C * (nb + (nb + 31) / 32);
}

long long scratch_words(long long n, int cols) {
  switch (cols) {
    case 1: return scratch_words<1>(n);
    case 2: return scratch_words<2>(n);
    case 3: return scratch_words<3>(n);
    default: return scratch_words<4>(n);
  }
}

template <typename T, int OP, bool REV, int C>
int launch(const void* values, const unsigned char* is_start, void* out,
           long long n, int* scratch, cudaStream_t s) {
  const int nb = pch::blocks_for(n, tile_rows<C>());
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, scratch_words<C>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* next_tile = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* agg = reinterpret_cast<unsigned long long*>(scratch + 2);
  unsigned long long* incl = agg + static_cast<long long>(nb) * C;
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  const bool vec = ((reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(is_start) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    segscan_kernel<T, OP, REV, C, true><<<nb, kThreads, 0, s>>>(v, is_start, o, n, nb, agg,
                                                                incl, next_tile);
  else
    segscan_kernel<T, OP, REV, C, false><<<nb, kThreads, 0, s>>>(v, is_start, o, n, nb, agg,
                                                                 incl, next_tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP, bool REV>
int launch_cols(int cols, const void* values, const unsigned char* is_start,
                void* out, long long n, int* scratch, cudaStream_t s) {
  switch (cols) {
    case 1: return launch<T, OP, REV, 1>(values, is_start, out, n, scratch, s);
    case 2: return launch<T, OP, REV, 2>(values, is_start, out, n, scratch, s);
    case 3: return launch<T, OP, REV, 3>(values, is_start, out, n, scratch, s);
    case 4: return launch<T, OP, REV, 4>(values, is_start, out, n, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int OP>
int launch_dir(int reverse, int cols, const void* values,
               const unsigned char* is_start, void* out, long long n,
               int* scratch, cudaStream_t s) {
  if (reverse) return launch_cols<T, OP, true>(cols, values, is_start, out, n, scratch, s);
  return launch_cols<T, OP, false>(cols, values, is_start, out, n, scratch, s);
}

template <typename T>
int launch_op(int op, int reverse, int cols, const void* values,
              const unsigned char* is_start, void* out, long long n,
              int* scratch, cudaStream_t s) {
  switch (op) {
    case kAdd: return launch_dir<T, kAdd>(reverse, cols, values, is_start, out, n, scratch, s);
    case kMax: return launch_dir<T, kMax>(reverse, cols, values, is_start, out, n, scratch, s);
    case kMin: return launch_dir<T, kMin>(reverse, cols, values, is_start, out, n, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PCH_API int pch_segscan_max_cols() { return kMaxCols; }

// int32 words of scratch pch_segscan needs for n rows of cols columns.
PCH_API long long pch_segscan_scratch(long long n, int cols) {
  return scratch_words(n, cols);
}

// values/out: int32 (dtype 0) or float32 (dtype 1) [n, cols] row-major,
// 1 <= cols <= 4; is_start: uint8[n]; op: 0 add, 1 max, 2 min.  n == 0
// launches nothing.
PCH_API int pch_segscan(const void* values, const unsigned char* is_start,
                        void* out, long long n, int cols, int op, int dtype,
                        int reverse, int* scratch, void* stream) {
  if (n < 0 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_op<int>(op, reverse, cols, values, is_start, out, n, scratch, s);
  if (dtype == 1)
    return launch_op<float>(op, reverse, cols, values, is_start, out, n, scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
