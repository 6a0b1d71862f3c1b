// Window sort of the within-cell code w by (k1, w) for the fused
// front-end's hierarchical sort.
//
// Replaces pointcloudhookup_tpu/ops/pallas/winsort.py::window_sort_w
// (pallas_calls at :184 and :192).  After the single-key sort by the cell
// key k1 (non-decreasing), full (k1, w) order is restored inside windows of
// W rows at offsets 0 and W/2: the first pass sorts windows [jW, jW + W),
// the second, which sees the first one's output, windows
// [W/2 + jW, 3W/2 + jW) that end inside the padded length.  Rows past n
// take part as (0xFFFFFFFF, 0x7FFF), the reference's padding, and are not
// written.  k1 is invariant (its rows are already sorted within every
// window), so only w is written.  W is any even size from 2 to 1024.
//
// Bound: device-memory bandwidth.  The function reads the u32 key k1 and
// the u16 code w and writes w as int32 once, 10 bytes a row; this kernel
// reads k1 in int64 and w in int32, as the port holds them.  The TPU kernel kept its network on one i32
// operand by ranking k1 inside the window; here the packed 64-bit key
// (k1 << 16) | w is sorted directly: one block per window loads its keys
// into shared memory, pads them to the next power of two with the largest
// key, runs a bitonic network there, and writes back w.  The second pass
// reads k1 again and w from the first pass's output (in place: windows of
// one pass are disjoint).
#include "common.cuh"

namespace {

constexpr unsigned long long kPadKey = (0xFFFFFFFFull << 16) | 0x7FFFull;
constexpr unsigned long long kFill = ~0ull;  // above every real or pad key

__global__ void winsort_kernel(const long long* __restrict__ k1,
                               const int* w_in, int* w_out, long long n,
                               int window, int p2, long long offset) {
  extern __shared__ unsigned long long key[];  // [p2]
  const long long start = offset + static_cast<long long>(blockIdx.x) * window;
  for (int s = threadIdx.x; s < p2; s += blockDim.x) {
    unsigned long long v = kFill;
    if (s < window) {
      const long long g = start + s;
      v = g < n ? (static_cast<unsigned long long>(k1[g] & 0xFFFFFFFFll) << 16) |
                      static_cast<unsigned long long>(w_in[g] & 0xFFFF)
                : kPadKey;
    }
    key[s] = v;
  }
  __syncthreads();
  const int pairs = p2 >> 1;
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);  // lower index of the pair
        const bool asc = (i & k) == 0;
        const unsigned long long a = key[i];
        const unsigned long long b = key[i + j];
        if ((a > b) == asc) {
          key[i] = b;
          key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int s = threadIdx.x; s < window; s += blockDim.x) {
    const long long g = start + s;
    if (g < n) w_out[g] = static_cast<int>(key[s] & 0xFFFFull);
  }
}

}  // namespace

// k1: int64[n] (u32 keys, non-decreasing), w: int32[n] (16-bit codes),
// out: int32[n]; window even, 2 <= window <= 1024.  out may not alias w.
PCH_API int pch_winsort(const long long* k1, const int* w, int* out,
                        long long n, int window, void* stream) {
  if (n < 0 || window < 2 || window > 1024 || (window & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int p2 = 1;
  while (p2 < window) p2 <<= 1;
  int threads = p2 >> 1;
  if (threads < 32) threads = 32;
  const size_t smem = static_cast<size_t>(p2) * sizeof(unsigned long long);
  const long long windows = (n + window - 1) / window;  // padded length / W
  winsort_kernel<<<static_cast<int>(windows), threads, smem, s>>>(
      k1, w, out, n, window, p2, 0);
  if (windows > 1) {
    winsort_kernel<<<static_cast<int>(windows - 1), threads, smem, s>>>(
        k1, out, out, n, window, p2, window / 2);
  }
  return static_cast<int>(cudaGetLastError());
}
