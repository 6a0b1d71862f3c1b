// Merge-path rounds of the two-level sort of the fused front-end's Morton
// keys.
//
// Replaces pointcloudhookup_tpu/ops/pallas/mergesort.py::merge_sort_2key's
// merge rounds (_merge_round, pallas_call at :274; the host-side co-rank
// search _partitions at :60-121 moves into the kernel).  The caller packs
// each (hi, lo) pair into one int64 key whose order is the pair's
// lexicographic order and sorts blocks of T keys (the blocked first phase,
// outside any kernel as in the reference).  Round r then merges sorted runs
// of length L = T * 2^r pairwise into runs of 2L, until one run is left:
// log2(n / T) rounds, n a power of two, T a power of two <= 8192.
//
// One block per T-row output tile.  The tile's two ends are cut by
// merge-path co-rank searches into the pair's runs A and B (ties go to A);
// the block loads A[i0, i1) and B[j0, j1) (T keys in all) into shared
// memory, each thread finds its own split of the tile by a co-rank search
// in shared memory and merges its share sequentially, and the block writes
// the tile back in order.  The output is identical to a full sort of the
// keys: a key is the whole record, so the order of equal keys is moot.
//
// Bound: device-memory bandwidth.  The function must read and write the n
// pairs once (16 bytes a row); the rounds move 16 bytes a row each
// (log2(n / T) times), plus the blocked sort.  The TPU kernel merged with a
// bitonic separator and cleaner because its vector unit cannot run a
// data-dependent sequential merge; a thread here can.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8192;

// Number of A's keys among the first k keys of merge(A, B), A first on
// ties (the merge-path co-rank).
template <typename Index>
__device__ __forceinline__ Index corank(const long long* a, Index la,
                                        const long long* b, Index lb,
                                        Index k) {
  Index lo = k > lb ? k - lb : 0;
  Index hi = k < la ? k : la;
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (a[mid] <= b[k - mid - 1]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_kernel(const long long* __restrict__ in,
                             long long* __restrict__ out, long long run,
                             int tile) {
  extern __shared__ long long smem[];
  long long* s_in = smem;          // [tile]: A's share, then B's
  long long* s_out = smem + tile;  // [tile]
  __shared__ long long cut[2];
  const long long g0 = static_cast<long long>(blockIdx.x) * tile;
  const long long abase = (g0 / (2 * run)) * (2 * run);
  const long long* a = in + abase;
  const long long* b = a + run;
  const long long k0 = g0 - abase;
  if (threadIdx.x == 0) cut[0] = corank<long long>(a, run, b, run, k0);
  if (threadIdx.x == blockDim.x - 1)
    cut[1] = corank<long long>(a, run, b, run, k0 + tile);
  __syncthreads();
  const long long i0 = cut[0];
  const int la = static_cast<int>(cut[1] - i0);
  const int lb = tile - la;
  const long long j0 = k0 - i0;
  for (int t = threadIdx.x; t < la; t += blockDim.x) s_in[t] = a[i0 + t];
  for (int t = threadIdx.x; t < lb; t += blockDim.x) s_in[la + t] = b[j0 + t];
  __syncthreads();
  const int items = tile / blockDim.x;
  const int d = threadIdx.x * items;
  const long long* sa = s_in;
  const long long* sb = s_in + la;
  int ia = corank<int>(sa, la, sb, lb, d);
  int ib = d - ia;
  for (int q = 0; q < items; ++q) {
    const bool take_a = ib >= lb || (ia < la && sa[ia] <= sb[ib]);
    s_out[d + q] = take_a ? sa[ia++] : sb[ib++];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) out[g0 + t] = s_out[t];
}

}  // namespace

// keys: int64[n] sorted in blocks of tile rows; scratch: int64[n].  Runs
// the log2(n / tile) merge rounds, ping-ponging between the two buffers:
// the sorted keys end in keys when the number of rounds is even, else in
// scratch.  n and tile powers of two, 32 <= tile <= 8192, n >= 2 * tile.
PCH_API int pch_merge_rounds(long long* keys, long long* scratch, long long n,
                             int tile, void* stream) {
  if (tile < 32 || tile > kMaxTile || (tile & (tile - 1)) || n < 2LL * tile ||
      (n & (n - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = tile < kThreads ? tile : kThreads;
  const size_t smem = 2 * static_cast<size_t>(tile) * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = static_cast<int>(n / tile);
  long long* src = keys;
  long long* dst = scratch;
  for (long long run = tile; run < n; run *= 2) {
    merge_kernel<<<tiles, threads, smem, s>>>(src, dst, run, tile);
    long long* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}
