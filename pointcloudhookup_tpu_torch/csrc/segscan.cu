// Segmented inclusive scan (add / max / min over int32 or float32).
//
// Replaces pointcloudhookup_tpu/ops/pallas/segscan.py::segmented_scan_pallas
// (pallas_call at :136).  Forward scans restart at rows whose flag is set;
// reverse scans run from the end and restart at segment ENDS, i.e. the
// reversed flags are is_start[i+1] with the last row always flagged
// (pointcloudhookup_tpu/ops/segments.py:95-99).
//
// Bound: device-memory bandwidth (two reads of values + flags, one write).
// The TPU kernel carried the running (flag, value) state through its
// sequential grid in SMEM; CUDA blocks run in no order, so the carry is a
// separate pass ("reduce, then scan"):
//   1. tile_reduce  each 4096-row tile's aggregate state
//   2. tile_carry   exclusive scan of the aggregates (one block)
//   3. tile_scan    rescan each tile, seeded with its carry, and write
// The combine rule is segscan.py's right-dominant one,
//   (fa, va) . (fb, vb) = (fa | fb, fb ? vb : op(va, vb)),
// made total with an explicit "empty" state instead of an identity value,
// so no identity is ever folded into a result: the first scanned row is
// always flagged, and every output reduces real rows only.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

template <typename T>
struct St {
  int has;  // 0: empty state (no rows)
  int f;    // a segment starts inside
  T v;      // op-reduction since the last start
};

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP>
__device__ __forceinline__ St<T> comb(St<T> a, St<T> b) {
  if (!a.has) return b;
  if (!b.has) return a;
  St<T> r;
  r.has = 1;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : apply<T, OP>(a.v, b.v);
  return r;
}

template <typename T>
__device__ __forceinline__ St<T> empty_state() {
  St<T> s;
  s.has = 0;
  s.f = 0;
  s.v = T(0);
  return s;
}

template <typename T>
__device__ __forceinline__ St<T> shfl_up(St<T> s, int d) {
  St<T> r;
  r.has = __shfl_up_sync(pch::kFullMask, s.has, d);
  r.f = __shfl_up_sync(pch::kFullMask, s.f, d);
  r.v = __shfl_up_sync(pch::kFullMask, s.v, d);
  return r;
}

// Row at scan position p: its array index, value and restart flag.
template <typename T>
__device__ __forceinline__ long long load_row(const T* __restrict__ values,
                                              const unsigned char* __restrict__ is_start,
                                              long long n, int reverse,
                                              long long p, T* v, int* f) {
  const long long a = reverse ? n - 1 - p : p;
  *v = values[a];
  if (p == 0) {
    *f = 1;
  } else if (reverse) {
    *f = is_start[a + 1] != 0;  // a < n - 1 here
  } else {
    *f = is_start[a] != 0;
  }
  return a;
}

// Exclusive block-wide scan of one state per thread; *total receives the
// combination of all threads' states.  Callable in a loop.
template <typename T, int OP>
__device__ St<T> block_exclusive(St<T> x, St<T>* warp_tot, St<T>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  St<T> incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const St<T> up = shfl_up(incl, d);
    if (lane >= d) incl = comb<T, OP>(up, incl);
  }
  St<T> lane_excl = shfl_up(incl, 1);
  if (lane == 0) lane_excl = empty_state<T>();
  __syncthreads();  // earlier readers of warp_tot are done
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    St<T> w = lane < kWarps ? warp_tot[lane] : empty_state<T>();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const St<T> up = shfl_up(w, d);
      if (lane >= d) w = comb<T, OP>(up, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  *total = warp_tot[kWarps - 1];
  const St<T> warp_excl = warp > 0 ? warp_tot[warp - 1] : empty_state<T>();
  return comb<T, OP>(warp_excl, lane_excl);
}

template <typename T, int OP>
__global__ void tile_reduce(const T* __restrict__ values,
                            const unsigned char* __restrict__ is_start,
                            long long n, int reverse, int* __restrict__ agg_f,
                            T* __restrict__ agg_v) {
  __shared__ St<T> warp_tot[kWarps];
  const long long p0 =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  St<T> acc = empty_state<T>();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long p = p0 + j;
    if (p < n) {
      St<T> r;
      r.has = 1;
      load_row(values, is_start, n, reverse, p, &r.v, &r.f);
      acc = comb<T, OP>(acc, r);
    }
  }
  St<T> total;
  block_exclusive<T, OP>(acc, warp_tot, &total);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = total.f;
    agg_v[blockIdx.x] = total.v;
  }
}

template <typename T, int OP>
__global__ void tile_carry(const int* __restrict__ agg_f,
                           const T* __restrict__ agg_v, int nb,
                           int* __restrict__ carry_has,
                           int* __restrict__ carry_f, T* __restrict__ carry_v) {
  __shared__ St<T> warp_tot[kWarps];
  St<T> run = empty_state<T>();  // identical in every thread
  for (int start = 0; start < nb; start += kThreads) {
    const int i = start + threadIdx.x;
    St<T> x = empty_state<T>();
    if (i < nb) {
      x.has = 1;
      x.f = agg_f[i];
      x.v = agg_v[i];
    }
    St<T> total;
    const St<T> ex = block_exclusive<T, OP>(x, warp_tot, &total);
    const St<T> c = comb<T, OP>(run, ex);
    if (i < nb) {
      carry_has[i] = c.has;
      carry_f[i] = c.f;
      carry_v[i] = c.v;
    }
    run = comb<T, OP>(run, total);
  }
}

template <typename T, int OP>
__global__ void tile_scan(const T* __restrict__ values,
                          const unsigned char* __restrict__ is_start,
                          long long n, int reverse,
                          const int* __restrict__ carry_has,
                          const int* __restrict__ carry_f,
                          const T* __restrict__ carry_v, T* __restrict__ out) {
  __shared__ St<T> warp_tot[kWarps];
  const long long p0 =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  T v[kItems];
  int f[kItems];
  long long a[kItems];
  St<T> acc = empty_state<T>();
  int count = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long p = p0 + j;
    if (p < n) {
      a[j] = load_row(values, is_start, n, reverse, p, &v[j], &f[j]);
      St<T> r;
      r.has = 1;
      r.f = f[j];
      r.v = v[j];
      acc = comb<T, OP>(acc, r);
      ++count;
    }
  }
  St<T> total;
  const St<T> ex = block_exclusive<T, OP>(acc, warp_tot, &total);
  St<T> c;
  c.has = carry_has[blockIdx.x];
  c.f = carry_f[blockIdx.x];
  c.v = carry_v[blockIdx.x];
  St<T> run = comb<T, OP>(c, ex);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < count) {
      St<T> r;
      r.has = 1;
      r.f = f[j];
      r.v = v[j];
      run = comb<T, OP>(run, r);
      out[a[j]] = run.v;
    }
  }
}

template <typename T, int OP>
int launch(const void* values, const unsigned char* is_start, void* out,
           long long n, int reverse, int* scratch, cudaStream_t s) {
  const int nb = pch::blocks_for(n, kTile);
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  int* agg_f = scratch;
  T* agg_v = reinterpret_cast<T*>(scratch + nb);
  int* carry_has = scratch + 2 * nb;
  int* carry_f = scratch + 3 * nb;
  T* carry_v = reinterpret_cast<T*>(scratch + 4 * nb);
  const T* v = static_cast<const T*>(values);
  tile_reduce<T, OP><<<nb, kThreads, 0, s>>>(v, is_start, n, reverse, agg_f,
                                            agg_v);
  tile_carry<T, OP><<<1, kThreads, 0, s>>>(agg_f, agg_v, nb, carry_has,
                                          carry_f, carry_v);
  tile_scan<T, OP><<<nb, kThreads, 0, s>>>(v, is_start, n, reverse, carry_has,
                                          carry_f, carry_v,
                                          static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_op(int op, const void* values, const unsigned char* is_start,
              void* out, long long n, int reverse, int* scratch,
              cudaStream_t s) {
  switch (op) {
    case kAdd:
      return launch<T, kAdd>(values, is_start, out, n, reverse, scratch, s);
    case kMax:
      return launch<T, kMax>(values, is_start, out, n, reverse, scratch, s);
    case kMin:
      return launch<T, kMin>(values, is_start, out, n, reverse, scratch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// 32-bit words of scratch pch_segscan needs for n rows.
PCH_API long long pch_segscan_scratch(long long n) {
  return 5LL * pch::blocks_for(n, kTile);
}

// values/out: int32 (dtype 0) or float32 (dtype 1) [n]; is_start: uint8[n];
// op: 0 add, 1 max, 2 min.
PCH_API int pch_segscan(const void* values, const unsigned char* is_start,
                        void* out, long long n, int op, int dtype,
                        int reverse, int* scratch, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_op<int>(op, values, is_start, out, n, reverse, scratch, s);
  if (dtype == 1)
    return launch_op<float>(op, values, is_start, out, n, reverse, scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
