// Windowed first-occurrence flags for the fused front-end's cell sort.
//
// Replaces pointcloudhookup_tpu/ops/pallas/dupwin.py::first_occurrence_flags
// (pallas_call at :99).  After the single-key sort by cell key k1 the rows
// of a cell are contiguous but not ordered by their within-cell code w, so
// duplicates of a voxel need not be adjacent:
//   flag[i] = 1 unless some j in [max(0, i - depth), i) has
//             k1[j] == k1[i] and w[j] == w[i].
// Both words are compared exactly, so a real voxel is never flagged as a
// duplicate.  Unlike the TPU kernel there is no rule that n be a multiple
// of 32768 and no depth < 128 cap: any n and any depth >= 1, any k1 order.
//
// Bound: device-memory bandwidth.  The function reads the u32 key k1 and
// w (4 bytes each) once and writes one flag byte per row, 9 bytes; this
// kernel reads k1 as the port holds it, in int64, so it moves 13.  The TPU
// kernel reached each row's predecessors with lane rolls of a second,
// shifted input view.  Here a block stages its 2,048-row tile and a
// depth-row halo in shared memory, so every row is read from device memory
// about (1 + depth / 2,048) times.  Comparing each row with all depth
// predecessors, 12 bytes of shared memory each, would be bound by
// shared-memory bandwidth (3.2 GB at depth 64 over 4M rows); instead:
//   * The loads of a thread's rows and of the halo go out in one batch, and
//     the rest of the block's work needs two barriers.
//   * One vote (__syncthreads_and) tells whether the tile and its halo have
//     non-decreasing k1, as the callers' keys always do.  There an earlier
//     row has the same k1 exactly when it lies inside the current run, so
//     only w is compared, back to the run start and no further than depth.
//     Run starts are flag bytes in shared memory; a thread finds the last
//     one before its rows 8 flags a load (the runs of the callers' keys
//     are a few rows long on average).
//   * A thread owns 8 consecutive rows and slides a register window of w
//     over their predecessors: each predecessor is read from shared memory
//     once for 8 rows (one word a row every 8 distances) and compared with
//     all 8 by unrolled code, one add-and-min instruction a compare.  w is
//     stored with one pad word every 8, so the lanes' loads fall in
//     distinct banks.
//   * A tile that is not non-decreasing takes the full (k1, w) compare, a
//     row a thread, in the same kernel.
// A depth whose halo does not fit in shared memory (beyond ~15,000 rows)
// takes a second kernel that reads the predecessors from device memory
// (through L2).
#include "common.cuh"

namespace {

constexpr int kR = 8;  // consecutive rows a thread
constexpr int kThreads = 256;
constexpr int kTile = kR * kThreads;  // rows per block
constexpr size_t kMaxShared = 227 * 1024;

// shared-memory index of w at staged position x: a pad word every 8
__host__ __device__ __forceinline__ int phys(int x) { return x + (x >> 3); }

__host__ __device__ __forceinline__ int halo_of(int depth) { return (depth + 7) & ~7; }

// Shared bytes of a block: k1 (int64), w (padded) and the run-start flags
// for the halo and the tile.
size_t shared_bytes(int depth) {
  const size_t span = static_cast<size_t>(halo_of(depth)) + kTile;
  return span * sizeof(long long) + ((phys(static_cast<int>(span)) + 1) & ~1) * sizeof(int) +
         span;
}

// Distances d0 .. d0 + 7 (d0 = 1 mod 8).  c[q mod 8] holds w at staged
// position loc0 + q for the 8 positions last loaded; the predecessors
// loc0 - d0 - t share one 8-word group, at padded index pg - t.  acc[r]
// keeps the least (c - w) mod 2**32 over row r's predecessors, 0 where one
// equals its w: one add-and-min instruction a compare.  CHECK: some row
// stops inside the group, at its own dm.
template <bool CHECK>
__device__ __forceinline__ void slide(unsigned (&c)[kR], const unsigned (&negw)[kR],
                                      unsigned (&acc)[kR], const int (&dm)[kR],
                                      const unsigned* sw, int pg, int d0, int dmax) {
#pragma unroll
  for (int t = 0; t < kR; ++t) {
    const int d = d0 + t;
    if (!CHECK || d <= dmax) c[kR - 1 - t] = sw[pg - t];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const unsigned diff = c[(r - 1 - t + 2 * kR) % kR] + negw[r];
      acc[r] = min(acc[r], CHECK && d > dm[r] ? ~0u : diff);
    }
  }
}

template <int DEPTH>  // 0: any depth
__global__ void __launch_bounds__(kThreads, 4)
dupwin_shared_kernel(const long long* __restrict__ k1, const int* __restrict__ w, long long n,
                     int depth_arg, unsigned char* __restrict__ out) {
  const int depth = DEPTH ? DEPTH : depth_arg;
  const int halo = halo_of(depth);
  const int span = halo + kTile;
  const int lo = halo - depth;  // first staged position
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sk = reinterpret_cast<long long*>(smem);            // [span]
  int* sw = reinterpret_cast<int*>(sk + span);                   // [phys(span)]
  unsigned char* sf = reinterpret_cast<unsigned char*>(sw + ((phys(span) + 1) & ~1));  // [span]
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  // stage k1 and w: the tile's 8 rows a thread and one halo row, every load
  // issued at once, then any further halo rows
  {
    long long key[kR + 1];
    int wq[kR + 1];
#pragma unroll
    for (int q = 0; q <= kR; ++q) {
      const int loc = q < kR ? halo + threadIdx.x + q * kThreads : lo + threadIdx.x;
      const long long g = base - halo + loc;
      if (g >= 0 && g < n && (q < kR || loc < halo)) {
        key[q] = k1[g];
        wq[q] = w[g];
      }
    }
#pragma unroll
    for (int q = 0; q <= kR; ++q) {
      const int loc = q < kR ? halo + threadIdx.x + q * kThreads : lo + threadIdx.x;
      const long long g = base - halo + loc;
      if (g >= 0 && g < n && (q < kR || loc < halo)) {
        sk[loc] = key[q];
        sw[phys(loc)] = wq[q];
      }
    }
  }
  for (int loc = lo + kThreads + threadIdx.x; loc < halo; loc += kThreads) {
    const long long g = base - halo + loc;
    if (g >= 0) {
      sk[loc] = k1[g];
      sw[phys(loc)] = w[g];
    }
  }
  __syncthreads();
  // run-start flags: position lo, row 0 and every change of k1, and every
  // position before them (no row's predecessors reach there); note whether
  // k1 is non-decreasing over the staged rows
  bool ok = true;
  for (int loc = threadIdx.x; loc < span; loc += kThreads) {
    const long long g = base - halo + loc;
    bool start = true;
    if (loc > lo && g > 0 && g < n) {
      start = sk[loc - 1] != sk[loc];
      ok &= sk[loc - 1] <= sk[loc];
    }
    sf[loc] = start;
  }
  const bool sorted = __syncthreads_and(ok);

  if (sorted) {
    const int loc0 = halo + threadIdx.x * kR;
    const long long i0 = base + threadIdx.x * kR;
    if (i0 >= n) return;
    // the last run start before the thread's rows, 8 flags a load (there is
    // one within depth + 8 positions)
    int st = 0;
    for (int p = loc0 - 8;; p -= 8) {
      const unsigned long long f = *reinterpret_cast<const unsigned long long*>(sf + p);
      if (f) {
        st = p + ((63 - __clzll(static_cast<long long>(f))) >> 3);
        break;
      }
    }
    const unsigned long long starts = *reinterpret_cast<const unsigned long long*>(sf + loc0);
    int dm[kR];
    unsigned negw[kR], c[kR], acc[kR];
    int dmax = 0, dmin = depth;
    const unsigned* swu = reinterpret_cast<const unsigned*>(sw);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if ((starts >> (8 * r)) & 0xFF) st = loc0 + r;
      dm[r] = min(loc0 + r - st, depth);
      if (i0 + r < n) {
        dmax = max(dmax, dm[r]);
        dmin = min(dmin, dm[r]);
      }
      c[r] = swu[phys(loc0) + r];
      negw[r] = 0u - c[r];
      acc[r] = ~0u;
    }
    for (int d0 = 1; d0 <= dmax; d0 += kR) {
      const int pg = phys(loc0 - d0);
      if (d0 + kR - 1 <= dmin) slide<false>(c, negw, acc, dm, swu, pg, d0, dmax);
      else slide<true>(c, negw, acc, dm, swu, pg, d0, dmax);
    }
    if (i0 + kR <= n) {
      unsigned long long flags = 0;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        flags |= static_cast<unsigned long long>(acc[r] != 0) << (8 * r);
      *reinterpret_cast<unsigned long long*>(out + i0) = flags;
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (i0 + r < n) out[i0 + r] = acc[r] != 0;
    }
    return;
  }

  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const long long i = base + r;
    if (i >= n) break;
    const int loc = halo + r;
    const long long key = sk[loc];
    const int wv = sw[phys(loc)];
    const int dmax = i < depth ? static_cast<int>(i) : depth;
    bool dup = false;
    for (int d = 1; d <= dmax; ++d) {
      dup |= (sk[loc - d] == key) & (sw[phys(loc - d)] == wv);
    }
    out[i] = dup ? 0 : 1;
  }
}

__global__ void dupwin_global_kernel(const long long* __restrict__ k1,
                                     const int* __restrict__ w, long long n,
                                     int depth,
                                     unsigned char* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long key = k1[i];
    const int wv = w[i];
    const long long dmax = i < depth ? i : depth;
    bool dup = false;
    for (long long d = 1; d <= dmax && !dup; ++d) {
      dup = k1[i - d] == key && w[i - d] == wv;
    }
    out[i] = dup ? 0 : 1;
  }
}

template <int DEPTH>
cudaError_t launch_shared(const long long* k1, const int* w, long long n, int depth,
                          unsigned char* out, size_t smem, cudaStream_t s) {
  auto kernel = dupwin_shared_kernel<DEPTH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<pch::blocks_for(n, kTile), kThreads, smem, s>>>(k1, w, n, depth, out);
  return cudaGetLastError();
}

}  // namespace

// k1: int64[n] (u32 keys), w: int32[n], out: uint8[n] (a torch.bool
// tensor, 8-byte aligned); 0 <= n, depth >= 1.
PCH_API int pch_dupwin(const long long* k1, const int* w, long long n,
                       int depth, unsigned char* out, void* stream) {
  if (n < 0 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = shared_bytes(depth);
  if (smem <= kMaxShared) {
    if (depth == 16) return static_cast<int>(launch_shared<16>(k1, w, n, depth, out, smem, s));
    if (depth == 64) return static_cast<int>(launch_shared<64>(k1, w, n, depth, out, smem, s));
    return static_cast<int>(launch_shared<0>(k1, w, n, depth, out, smem, s));
  }
  long long grid = pch::blocks_for(n, kThreads);
  if (grid > 65535) grid = 65535;
  dupwin_global_kernel<<<static_cast<int>(grid), kThreads, 0, s>>>(k1, w, n, depth, out);
  return static_cast<int>(cudaGetLastError());
}
