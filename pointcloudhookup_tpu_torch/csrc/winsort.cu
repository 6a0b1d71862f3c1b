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
// window), so only w is written.  W is any even size from 2 up.
//
// Bound: device-memory bandwidth.  The function reads the u32 key k1 and
// the u16 code w and writes w as int32 once, 10 bytes a row; this kernel
// reads k1 in int64 and w in int32, as the port holds them.  The TPU kernel kept its network on one i32
// operand by ranking k1 inside the window; here the packed 64-bit key
// (k1 << 16) | w is sorted directly by a bitonic network over the window
// padded to the next power of two p2 with a key above every real one.
// Up to p2 = 4,096 keys (32 KB) one block sorts one window in shared
// memory and writes back w: one launch a pass.  A larger window is cut
// into chunks of 4,096 keys in a scratch buffer, so that a pass still
// spreads over many blocks (one block a window of 16,384 keys would leave
// most SMs idle): one launch loads and sorts every chunk, then each later
// merge size k runs its long strides (j >= 4,096) one launch per stride
// over the scratch, and its short ones in one more chunk launch in shared
// memory; the last writes w.  The second pass reads k1 again and w from
// the first pass's output (in place: windows of one pass are disjoint, and
// a window is read before it is written).
#include "common.cuh"

namespace {

constexpr unsigned long long kPadKey = (0xFFFFFFFFull << 16) | 0x7FFFull;
constexpr unsigned long long kFill = ~0ull;  // above every real or pad key
constexpr int kChunk = 4096;  // keys a block sorts in shared memory
constexpr long long kStrideBlocks = 2048;  // a stride launch's grid, at most

// The bitonic stages k = k_lo .. k_hi (powers of two), each with strides
// j = min(k, c) / 2 .. 1, over the c keys of one chunk in shared memory.
// Key v0 + i of the padded window sequence (windows p2-aligned) sorts
// ascending in stage k iff bit k of its index within its window is 0.
__device__ void bitonic_chunk(unsigned long long* key, int c, long long v0,
                              int p2, int k_lo, int k_hi) {
  const int pairs = c >> 1;
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (k < c ? k : c) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);  // lower index of the pair
        const bool asc = (((v0 + i) & (p2 - 1)) & k) == 0;
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
}

// One block a chunk of c keys.  Stage k_lo == 2 loads the chunk from
// (k1, w_in), any other from scratch; stage k_hi == p2 (the window sorted)
// writes w_out, any other scratch.
__global__ void winsort_chunk_kernel(const long long* __restrict__ k1,
                                     const int* w_in, int* w_out,
                                     unsigned long long* scratch, long long n,
                                     int window, int p2, int c,
                                     long long offset, int k_lo, int k_hi) {
  extern __shared__ unsigned long long key[];  // [c]
  const long long v0 = static_cast<long long>(blockIdx.x) * c;
  const long long win = v0 / p2;
  const int s0 = static_cast<int>(v0 - win * p2);  // chunk start in its window
  const long long start = offset + win * window;   // the window's first row
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    unsigned long long v;
    if (k_lo == 2) {
      const int s = s0 + i;
      v = kFill;
      if (s < window) {
        const long long g = start + s;
        v = g < n ? (static_cast<unsigned long long>(k1[g] & 0xFFFFFFFFll) << 16) |
                        static_cast<unsigned long long>(w_in[g] & 0xFFFF)
                  : kPadKey;
      }
    } else {
      v = scratch[v0 + i];
    }
    key[i] = v;
  }
  __syncthreads();
  bitonic_chunk(key, c, v0, p2, k_lo, k_hi);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    if (k_hi == p2) {
      const int s = s0 + i;
      const long long g = start + s;
      if (s < window && g < n) w_out[g] = static_cast<int>(key[i] & 0xFFFFull);
    } else {
      scratch[v0 + i] = key[i];
    }
  }
}

// One compare-exchange stride (k, j) over every window's p2 keys in scratch.
__global__ void winsort_stride_kernel(unsigned long long* scratch,
                                      long long pairs, int p2, int k, int j) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < pairs; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = 2LL * j * (t / j) + (t % j);
    const bool asc = ((i & (p2 - 1)) & k) == 0;
    const unsigned long long a = scratch[i];
    const unsigned long long b = scratch[i + j];
    if ((a > b) == asc) {
      scratch[i] = b;
      scratch[i + j] = a;
    }
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// One pass over `windows` windows starting at row offset.
void sort_pass(const long long* k1, const int* w_in, int* w_out,
               unsigned long long* scratch, long long n, int window, int p2,
               long long offset, long long windows, cudaStream_t s) {
  const int c = p2 < kChunk ? p2 : kChunk;
  const int threads = (c >> 1) < 32 ? 32 : (c >> 1) > 1024 ? 1024 : c >> 1;
  const size_t smem = static_cast<size_t>(c) * sizeof(unsigned long long);
  const long long chunks = windows * (p2 / c);
  winsort_chunk_kernel<<<static_cast<unsigned>(chunks), threads, smem, s>>>(
      k1, w_in, w_out, scratch, n, window, p2, c, offset, 2, c);
  const long long pairs = windows * p2 / 2;
  long long grid = (pairs + 255) / 256;
  if (grid > kStrideBlocks) grid = kStrideBlocks;
  for (int k = 2 * c; k <= p2; k <<= 1) {
    for (int j = k >> 1; j >= c; j >>= 1) {
      winsort_stride_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
          scratch, pairs, p2, k, j);
    }
    winsort_chunk_kernel<<<static_cast<unsigned>(chunks), threads, smem, s>>>(
        k1, w_in, w_out, scratch, n, window, p2, c, offset, k, k);
  }
}

}  // namespace

// Scratch bytes pch_winsort needs: 0 where a window fits one chunk, else
// 8 bytes for each padded key of the first pass.
PCH_API long long pch_winsort_scratch(long long n, int window) {
  if (n <= 0 || window < 2) return 0;
  const int p2 = pow2_at_least(window);
  if (p2 <= kChunk) return 0;
  const long long windows = (n + window - 1) / window;
  return windows * p2 * static_cast<long long>(sizeof(unsigned long long));
}

// k1: int64[n] (u32 keys, non-decreasing), w: int32[n] (16-bit codes),
// out: int32[n]; window even and >= 2; scratch: pch_winsort_scratch(n,
// window) bytes.  out may not alias w.
PCH_API int pch_winsort(const long long* k1, const int* w, int* out,
                        long long n, int window, void* scratch, void* stream) {
  if (n < 0 || window < 2 || (window & 1) || window > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p2 = pow2_at_least(window);
  auto* keys = static_cast<unsigned long long*>(scratch);
  const long long windows = (n + window - 1) / window;  // padded length / W
  sort_pass(k1, w, out, keys, n, window, p2, 0, windows, s);
  if (windows > 1) sort_pass(k1, out, out, keys, n, window, p2, window / 2, windows - 1, s);
  return static_cast<int>(cudaGetLastError());
}
