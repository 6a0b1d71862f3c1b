// Two-level merge sort of (hi, lo) int32 pairs: the fused front-end's
// sort_mode "merge".
//
// Replaces pointcloudhookup_tpu/ops/pallas/mergesort.py::merge_sort_2key: its
// blocked lax.sort (:292) and its merge rounds (_merge_round, pallas_call at
// :274; the host-side co-rank search _partitions at :60-121 moves into the
// kernel).  Each pair is one int64 key, hi * 2**32 + (lo + 2**31), whose
// order is the pair's lexicographic order for every int32 pair.
//
//   1. block_sort_kernel reads hi and lo with 16-byte loads, packs the keys
//      in registers and sorts every block of `block` rows: 16 keys per
//      thread by an odd-even transposition network in registers, then
//      merge-path passes in shared memory over runs of 16, 32, ... up to
//      block.  One CUDA block holds 8,192 keys (68 KB of shared memory):
//      one block of rows, or 8192 / block of them.
//   2. merge_kernel, once per round: round r merges the runs of
//      L = block * 2^r rows pairwise, log2(n / block) rounds in all.  One
//      CUDA block per output tile of 2,048 keys (128 threads x 16 keys,
//      17 KB of shared memory, so a dozen tiles share an SM and hide each
//      other's memory latency).  Warps 0 and 1 find the tile's two
//      merge-path co-ranks in device memory by a 32-way search (one probe a
//      lane, about five dependent loads for a 2M-row run); cp.async copies
//      the A and B windows into shared memory; each thread finds its own
//      co-rank there and merges 16 keys into registers; the tile leaves
//      through shared memory in coalesced stores.  The last round writes
//      hi and lo as int32 instead of the keys.
// The output is identical to a full sort of the keys: a key is the whole
// record, so the order of equal keys is moot.
//
// Bound: device-memory bandwidth.  The function reads and writes the n
// pairs once (16 bytes a row); the block sort and every round move 16 bytes
// a row each, 1 + log2(n / block) passes in all (10 at 4M rows, block
// 8,192), mostly through the 50 MB L2 at that size.  The TPU kernel merged
// with a bitonic separator because its vector unit cannot run a
// data-dependent sequential merge; a thread here can.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kItems = 16;  // keys a thread sorts or merges
constexpr int kSortThreads = 512;
constexpr int kSortTile = kSortThreads * kItems;  // 8192 keys
constexpr int kMergeTile = 2048;
constexpr int kMergeThreads = kMergeTile / kItems;  // 128

// Shared-memory slot of key i: one pad word every 16 keys, so the 16-key
// runs that neighbouring threads own start on different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ long long pack_key(int hi, int lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<long long>(hi)) << 32) |
      (static_cast<unsigned>(lo) ^ 0x80000000u));
}

__device__ __forceinline__ void compare_swap(long long& a, long long& b) {
  const long long lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Co-rank of diagonal k between the sorted runs A = s[a0, a0 + la) and
// B = s[b0, b0 + lb) of shared memory (logical key indices): the number of
// A's keys among the first k of merge(A, B), ties to A.
__device__ __forceinline__ int smem_corank(const long long* s, int a0, int la,
                                           int b0, int lb, int k) {
  int lo = k > lb ? k - lb : 0;
  int hi = k < la ? k : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[padded(a0 + mid)] <= s[padded(b0 + k - mid - 1)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merges `count` keys of A = s[a0, a0 + la) and B = s[b0, b0 + lb) into
// out[0, count), starting at A's key ia and B's key ib (a co-rank pair).
// The head of a run that is used up is never taken: it reads the other
// run's first key instead, which lies inside the array.
__device__ __forceinline__ void smem_merge(const long long* s, int a0, int la,
                                           int b0, int lb, int ia, int ib,
                                           int count, long long (&out)[kItems]) {
  long long va = s[padded(ia < la ? a0 + ia : b0)];
  long long vb = s[padded(ib < lb ? b0 + ib : a0)];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (q < count) {
      const bool take_a = ib >= lb || (ia < la && va <= vb);
      out[q] = take_a ? va : vb;
      if (take_a) {
        ++ia;
        va = s[padded(ia < la ? a0 + ia : b0)];
      } else {
        ++ib;
        vb = s[padded(ib < lb ? b0 + ib : a0)];
      }
    }
  }
}

__global__ void __launch_bounds__(kSortThreads)
    block_sort_kernel(const int* __restrict__ hi, const int* __restrict__ lo,
                      long long* __restrict__ keys, long long n, int block) {
  extern __shared__ long long s[];  // padded(kSortTile) keys
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  // n is a power of two: a tile is full, or the whole input (n < 8192);
  // the rest of the tile is padding, in segments of its own
  const int len = n - base < kSortTile ? static_cast<int>(n - base) : kSortTile;
  const int4* hi4 = reinterpret_cast<const int4*>(hi + base);
  const int4* lo4 = reinterpret_cast<const int4*>(lo + base);
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) {
    const int v = threadIdx.x + j * kSortThreads;
    const int r = 4 * v;
    if (r < len) {
      const int4 h = hi4[v];
      const int4 l = lo4[v];
      s[padded(r)] = pack_key(h.x, l.x);
      s[padded(r + 1)] = pack_key(h.y, l.y);
      s[padded(r + 2)] = pack_key(h.z, l.z);
      s[padded(r + 3)] = pack_key(h.w, l.w);
    } else {
      for (int c = 0; c < 4; ++c) s[padded(r + c)] = LLONG_MAX;
    }
  }
  __syncthreads();
  const int d = threadIdx.x * kItems;
  long long k[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) k[q] = s[padded(d + q)];
#pragma unroll
  for (int p = 0; p < kItems; ++p) {
#pragma unroll
    for (int q = p & 1; q + 1 < kItems; q += 2) compare_swap(k[q], k[q + 1]);
  }
  for (int w = kItems; w < block; w *= 2) {
    __syncthreads();  // every thread has read the previous pass
#pragma unroll
    for (int q = 0; q < kItems; ++q) s[padded(d + q)] = k[q];
    __syncthreads();
    const int a0 = d & ~(2 * w - 1);
    const int diag = d - a0;
    const int ia = smem_corank(s, a0, w, a0 + w, w, diag);
    smem_merge(s, a0, w, a0 + w, w, ia, diag - ia, kItems, k);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kItems; ++q) s[padded(d + q)] = k[q];
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kSortThreads) keys[base + i] = s[padded(i)];
}

// Co-rank of diagonal k between the sorted runs a[0, len) and b[0, len) in
// device memory, by the whole warp: each step probes 32 points of the
// remaining range at once (the predicate a[p] <= b[k - p - 1] holds on a
// prefix of it), so the range shrinks 33-fold per dependent load.
__device__ long long warp_corank(const long long* a, const long long* b,
                                 long long len, long long k) {
  const int lane = threadIdx.x & 31;
  long long lo = k > len ? k - len : 0;
  long long hi = k < len ? k : len;
  while (lo < hi) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;
    const int c = __popc(__ballot_sync(pch::kFullMask, a[p] <= b[k - p - 1]));
    const long long p_below = __shfl_sync(pch::kFullMask, p, c > 0 ? c - 1 : 0);
    const long long p_above = __shfl_sync(pch::kFullMask, p, c < 32 ? c : 31);
    if (c > 0) lo = p_below + 1;
    if (c < 32) hi = p_above;
  }
  return lo;
}

__device__ __forceinline__ void cp_async8(long long* smem, const long long* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}

// One round: in holds sorted runs of `run` keys; the output tile of `tile`
// keys (a power of two <= 2 * run) at blockIdx.x * tile is merged from its
// pair of runs.  Writes keys to out, or with hi_out set unpacks to hi_out
// and lo_out.
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                 int* __restrict__ hi_out, int* __restrict__ lo_out,
                 long long run, int tile) {
  extern __shared__ long long s[];  // padded(tile) keys
  __shared__ long long cut[2];
  const long long g0 = static_cast<long long>(blockIdx.x) * tile;
  const long long abase = g0 & ~(2 * run - 1);
  const long long* a = in + abase;
  const long long* b = a + run;
  const long long k0 = g0 - abase;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: the tile's first co-rank, warp 1: its end
    const long long c = warp_corank(a, b, run, k0 + warp * tile);
    if ((threadIdx.x & 31) == 0) cut[warp] = c;
  }
  __syncthreads();
  const long long i0 = cut[0];
  const int la = static_cast<int>(cut[1] - i0);
  const int lb = tile - la;
  const long long j0 = k0 - i0;
  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    cp_async8(&s[padded(t)], t < la ? a + i0 + t : b + j0 + (t - la));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int items = tile / blockDim.x;
  const int d = threadIdx.x * items;
  long long k[kItems];
  const int ia = smem_corank(s, 0, la, la, lb, d);
  smem_merge(s, 0, la, la, lb, ia, d - ia, items, k);
  __syncthreads();  // every thread has read the windows
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    if (q < items) s[padded(d + q)] = k[q];
  __syncthreads();
  if (hi_out == nullptr) {
    for (int t = threadIdx.x; t < tile; t += blockDim.x) out[g0 + t] = s[padded(t)];
    return;
  }
  int4* h4 = reinterpret_cast<int4*>(hi_out + g0);
  int4* l4 = reinterpret_cast<int4*>(lo_out + g0);
  for (int v = threadIdx.x; v < tile / 4; v += blockDim.x) {
    int h[4], l[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long key = s[padded(4 * v + c)];
      h[c] = static_cast<int>(key >> 32);
      l[c] = static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
    }
    h4[v] = make_int4(h[0], h[1], h[2], h[3]);
    l4[v] = make_int4(l[0], l[1], l[2], l[3]);
  }
}

bool bad_shape(long long n, int block) {
  return block < 32 || block > kSortTile || (block & (block - 1)) ||
         n < 2LL * block || (n & (n - 1));
}

}  // namespace

// hi, lo: int32[n], 16-byte aligned; keys: int64[n] <- the packed keys,
// sorted in blocks of `block` rows.  n and block powers of two,
// 32 <= block <= 8192, n >= 2 * block.
PCH_API int pch_block_sort(const int* hi, const int* lo, long long* keys,
                           long long n, int block, void* stream) {
  if (bad_shape(n, block) || (reinterpret_cast<uintptr_t>(hi) & 15) ||
      (reinterpret_cast<uintptr_t>(lo) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = padded(kSortTile) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n < kSortTile ? 1 : static_cast<int>(n / kSortTile);
  block_sort_kernel<<<grid, kSortThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      hi, lo, keys, n, block);
  return static_cast<int>(cudaGetLastError());
}

// keys: int64[n] sorted in blocks of `block` rows (overwritten); scratch:
// int64[n]; hi_out, lo_out: int32[n], 16-byte aligned, <- the sorted pairs.
// Runs the log2(n / block) merge rounds, ping-ponging between keys and
// scratch; the last round unpacks.
PCH_API int pch_merge_rounds(long long* keys, long long* scratch, int* hi_out,
                             int* lo_out, long long n, int block, void* stream) {
  if (bad_shape(n, block) || (reinterpret_cast<uintptr_t>(hi_out) & 15) ||
      (reinterpret_cast<uintptr_t>(lo_out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* src = keys;
  long long* dst = scratch;
  for (long long run = block; run < n; run *= 2) {
    const bool last = 2 * run == n;
    const int tile = 2 * run < kMergeTile ? static_cast<int>(2 * run) : kMergeTile;
    // 64 threads at least: warps 0 and 1 search the two co-ranks
    const int threads = tile / kItems < 64 ? 64 : tile / kItems;
    merge_kernel<<<static_cast<unsigned>(n / tile), threads,
                   padded(tile) * sizeof(long long), s>>>(
        src, dst, last ? hi_out : nullptr, last ? lo_out : nullptr, run, tile);
    long long* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}
