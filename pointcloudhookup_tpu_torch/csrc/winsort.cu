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
// the u16 code w and writes w as int32 once, 10 bytes a row; the port holds
// k1 in int64 and w in int32, so this kernel moves 16.  A network of
// packed 64-bit keys in shared memory, a barrier a stage and a launch a
// pass, would be bound by its barriers and its traffic instead.  Design,
// after the TPU kernel's:
//   * Ranked 32-bit keys.  Inside a window the rows are grouped by the
//     sorted k1, so sorting by (k1, w) is sorting by (rank << 16) | w, with
//     rank the number of k1 changes before the row in its window: one u32
//     word for W up to 32,768 (15 bits of rank).  Change flags are staged
//     in shared memory, counted by a block scan; k1 is read for them only.
//   * Keys in registers (winsort_net.cuh).  Up to W 256 a warp sorts a
//     window with no shared memory and no barrier (shuffles and exchanges
//     inside a thread); up to 4,096 a window spans several warps of one
//     block, and only the strides of 32 K and up take a barrier.
//   * Both passes in one launch.  A block holds G = T + 1 consecutive
//     first-pass windows; after sorting them it hands the second half of
//     each and the first half of the next over in shared memory, one half
//     reversed, and the T offset windows need only a bitonic merge
//     (log2 W stages), as the TPU kernel's pass B.  Each row is read once
//     and written once, with 1/T of the first pass done twice.
// A window above 4,096 rows is cut into chunks of 4,096 keys in a scratch
// buffer, so that a pass still spreads over many blocks: one launch loads
// and sorts every chunk in registers, then each later merge size k runs its
// long strides (j >= 4,096) one launch per stride over the scratch, and its
// short ones in one more chunk launch (a register merge); the last writes
// w.  Up to W 32,768 the chunks hold ranked u32 keys (a count launch adds
// up each chunk's k1 changes first); above, packed (k1 << 16) | w in 64
// bits.  The second pass reads w from the first pass's output in place
// (windows of one pass are disjoint; a window is read before it is
// written).
#include "block_scan.cuh"
#include "common.cuh"
#include "winsort_net.cuh"

namespace {

constexpr unsigned kPadK1 = 0xFFFFFFFFu;
constexpr unsigned kPadW = 0x7FFFu;
constexpr unsigned long long kPadKey64 = (0xFFFFFFFFull << 16) | 0x7FFFull;
constexpr int kMaxRanked = 32768;  // rank < 2**15 up to this window
constexpr int kLogChunk = 12;
constexpr int kChunk = 1 << kLogChunk;  // keys a block sorts above W 4,096
constexpr int kChunkK = 8;
constexpr int kChunkThreads = kChunk / kChunkK;
constexpr long long kStrideBlocks = 2048;

template <typename Key>
__device__ __forceinline__ Key fill_key() { return ~Key(0); }

__device__ __forceinline__ unsigned k1_at(const long long* k1, long long row, long long n) {
  return row < n ? static_cast<unsigned>(k1[row]) : kPadK1;
}

// (w & 0xFFFF) | change flag << 16 of window-local position s at row
// `row`; the flag is 1 where k1 differs from the row before and s > 0.
__device__ __forceinline__ unsigned staged_word(const long long* k1, const int* w,
                                                long long row, long long n, int s) {
  const unsigned key = k1_at(k1, row, n);
  const unsigned wv = row < n ? static_cast<unsigned>(w[row]) & 0xFFFFu : kPadW;
  const bool change = s > 0 && key != k1_at(k1, row - 1, n);
  return wv | (change ? 1u << 16 : 0u);
}

// ---------------------------------------------------------------- W <= 4,096

// One block: G = S / P2 consecutive windows of the first pass (window g at
// slots [g P2, g P2 + W), fills above), then the T = G - 1 offset windows.
// windows: ceil(n / W), the padded length over W.
template <int K, int THREADS, int LOG_P2>
__global__ void __launch_bounds__(THREADS)
winsort_windows_kernel(const long long* __restrict__ k1, const int* __restrict__ w,
                       int* __restrict__ out, long long n, int window, long long windows) {
  constexpr int S = THREADS * K;
  constexpr int P2 = 1 << LOG_P2;
  constexpr int G = S / P2;
  constexpr int T = G - 1;
  static_assert(G >= 2, "a block holds two windows at least");
  extern __shared__ __align__(16) unsigned sm[];  // [S]
  __shared__ int base1[G];          // change count at each window's start
  __shared__ int base2[G];          // ... and at its middle (offset window g)
  __shared__ int warp_sums[THREADS / 32];
  const int half = window / 2;
  const long long win0 = static_cast<long long>(blockIdx.x) * T;
  const long long row0 = win0 * window;
  const unsigned tbase = threadIdx.x * K;

  // 1. stage w and the k1 change flags, coalesced, every load at once; the
  // row before a slot is the lane before's, loaded again only at a lane or
  // window start
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int slot = threadIdx.x + q * THREADS, g = slot >> LOG_P2, s = slot & (P2 - 1);
    const long long row = row0 + static_cast<long long>(g) * window + s;
    const unsigned key = k1_at(k1, row, n);
    unsigned before = __shfl_up_sync(pch::kFullMask, key, 1);
    if (((threadIdx.x & 31) == 0 || s == 0) && slot > 0) before = k1_at(k1, row - 1, n);
    const unsigned wv = row < n ? static_cast<unsigned>(w[row]) & 0xFFFFu : kPadW;
    sm[slot] = s < window ? wv | (slot > 0 && key != before ? 1u << 16 : 0u) : 0u;
  }
  __syncthreads();

  // 2. ranks: the block's inclusive count of changes at each slot, less the
  // count at the window's first slot
  unsigned v[K];
  shared_to_regs<unsigned, K>(v, sm);
  int count = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) count += (v[r] >> 16) & 1;
  int total;
  int c = block_exclusive_sum<THREADS>(count, warp_sums, &total);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int slot = tbase + r, g = slot >> LOG_P2, s = slot & (P2 - 1);
    c += (v[r] >> 16) & 1;
    v[r] = (static_cast<unsigned>(c) << 16) | (v[r] & 0xFFFFu);
    if (s == 0) base1[g] = c;
    if (s == half) base2[g] = c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int slot = tbase + r, g = slot >> LOG_P2, s = slot & (P2 - 1);
    v[r] = s < window ? v[r] - (static_cast<unsigned>(base1[g]) << 16) : fill_key<unsigned>();
  }

  // 3. the first pass
  bitonic<unsigned, K, THREADS, LOG_P2, 1>(v, sm, false);

  // 4. hand over: each key re-ranked for its offset window (a row keeps its
  // k1, so the shift is one number for each half window)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int slot = tbase + r, g = slot >> LOG_P2, s = slot & (P2 - 1);
    if (s < window) {
      const int shift = s >= half ? base1[g] - base2[g] : g > 0 ? base1[g] - base2[g - 1] : 0;
      sm[slot] = v[r] + (static_cast<unsigned>(shift) << 16);
    }
  }
  __syncthreads();
  // rows only the first pass writes: the first half of window 0 and the
  // second half of the last window (all of it where there is one window)
  if (win0 == 0 || win0 + G > windows - 1) {
    for (int slot = threadIdx.x; slot < S; slot += THREADS) {
      const int g = slot >> LOG_P2, s = slot & (P2 - 1);
      const long long gw = win0 + g;
      if (s < window && ((gw == 0 && s < half) || (gw == windows - 1 && s >= half))) {
        const long long row = gw * window + s;
        if (row < n) out[row] = static_cast<int>(sm[slot] & 0xFFFFu);
      }
    }
  }
  // offset window o: the second half of window o ascending, fills, the
  // first half of window o + 1 descending -- a bitonic sequence
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int slot = tbase + r, o = slot >> LOG_P2, m = slot & (P2 - 1);
    unsigned key = fill_key<unsigned>();
    if (o < T) {
      if (m < half) key = sm[(o << LOG_P2) + half + m];
      else if (m >= P2 - half) key = sm[((o + 1) << LOG_P2) + (P2 - 1 - m)];
    }
    v[r] = key;
  }
  __syncthreads();

  // 5. the second pass: a merge
  bitonic<unsigned, K, THREADS, LOG_P2, LOG_P2>(v, sm, false);
  __syncthreads();
  regs_to_shared<unsigned, K>(sm, v);
  __syncthreads();
  for (int slot = threadIdx.x; slot < S; slot += THREADS) {
    const int o = slot >> LOG_P2, m = slot & (P2 - 1);
    const long long gw = win0 + o;
    if (o < T && m < window && gw <= windows - 2) {
      const long long row = gw * window + half + m;
      if (row < n) out[row] = static_cast<int>(sm[slot] & 0xFFFFu);
    }
  }
}

template <int K, int THREADS, int LOG_P2>
cudaError_t launch_windows(const long long* k1, const int* w, int* out, long long n,
                           int window, long long windows, cudaStream_t s) {
  constexpr int S = THREADS * K;
  constexpr int T = (S >> LOG_P2) - 1;
  const size_t smem = S * sizeof(unsigned);
  auto kernel = winsort_windows_kernel<K, THREADS, LOG_P2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long blocks = (windows - 1 + T - 1) / T;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(k1, w, out, n, window, windows);
  return cudaGetLastError();
}

// (keys a thread, threads) for each padded window: a warp a window up to
// 256 (8 windows a block there: smaller blocks measured faster than 16),
// G >= 4 windows a block above (G = 4 at 2,048 and 4,096).
cudaError_t sort_windows(const long long* k1, const int* w, int* out, long long n, int window,
                         int p2, long long windows, cudaStream_t s) {
  switch (p2) {
    case 2: return launch_windows<2, 256, 1>(k1, w, out, n, window, windows, s);
    case 4: return launch_windows<2, 256, 2>(k1, w, out, n, window, windows, s);
    case 8: return launch_windows<2, 256, 3>(k1, w, out, n, window, windows, s);
    case 16: return launch_windows<2, 256, 4>(k1, w, out, n, window, windows, s);
    case 32: return launch_windows<2, 256, 5>(k1, w, out, n, window, windows, s);
    case 64: return launch_windows<2, 256, 6>(k1, w, out, n, window, windows, s);
    case 128: return launch_windows<4, 256, 7>(k1, w, out, n, window, windows, s);
    case 256: return launch_windows<8, 256, 8>(k1, w, out, n, window, windows, s);
    case 512: return launch_windows<8, 512, 9>(k1, w, out, n, window, windows, s);
    case 1024: return launch_windows<8, 1024, 10>(k1, w, out, n, window, windows, s);
    case 2048: return launch_windows<8, 1024, 11>(k1, w, out, n, window, windows, s);
    case 4096: return launch_windows<16, 1024, 12>(k1, w, out, n, window, windows, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- W > 4,096

// Per chunk of the padded window sequence (p2-aligned windows, kChunk keys
// a chunk): the k1 changes at window positions 1 .. W - 1 inside it.
__global__ void __launch_bounds__(256)
winsort_count_kernel(const long long* __restrict__ k1, long long n, int window, int p2,
                     long long offset, int* __restrict__ counts) {
  __shared__ int warp_sums[256 / 32];
  const long long v0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long win = v0 / p2;
  const int s0 = static_cast<int>(v0 - win * p2);
  const long long start = offset + win * window;
  int c = 0;
  for (int i = threadIdx.x; i < kChunk; i += 256) {
    const int s = s0 + i;
    if (s > 0 && s < window)
      c += k1_at(k1, start + s, n) != k1_at(k1, start + s - 1, n);
  }
  int total;
  block_exclusive_sum<256>(c, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One block a chunk.  FIRST: load the chunk from (k1, w_in) and sort it
// (stages 2 .. kChunk); else load it from scratch and run the strides
// below kChunk of merge stage k.  Stage k == p2 (the window sorted) writes
// w_out, any other scratch.  Key u32: ranked keys (counts from
// winsort_count_kernel); u64: packed (k1 << 16) | w.
template <typename Key, bool FIRST>
__global__ void __launch_bounds__(kChunkThreads)
winsort_chunk_kernel(const long long* __restrict__ k1, const int* w_in, int* w_out,
                     Key* scratch, const int* __restrict__ counts, long long n, int window,
                     int p2, long long offset, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Key* sm = reinterpret_cast<Key*>(smem_raw);  // [kChunk]
  __shared__ int warp_sums[kChunkThreads / 32];
  const long long v0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long win = v0 / p2;
  const int s0 = static_cast<int>(v0 - win * p2);  // chunk start in its window
  const long long start = offset + win * window;   // the window's first row
  const unsigned tbase = threadIdx.x * kChunkK;
  Key v[kChunkK];
  if constexpr (FIRST) {
    if constexpr (sizeof(Key) == 4) {
      unsigned* st = reinterpret_cast<unsigned*>(smem_raw);
#pragma unroll
      for (int q = 0; q < kChunkK; ++q) {
        const int i = threadIdx.x + q * kChunkThreads, s = s0 + i;
        st[i] = s < window ? staged_word(k1, w_in, start + s, n, s) : 0u;
      }
      __syncthreads();
      shared_to_regs<unsigned, kChunkK>(v, st);
      int count = 0;
#pragma unroll
      for (int r = 0; r < kChunkK; ++r) count += (v[r] >> 16) & 1;
      int total;
      int c = block_exclusive_sum<kChunkThreads>(count, warp_sums, &total);
      const long long first_chunk = win * (p2 / kChunk);
      for (long long q = first_chunk; q < static_cast<long long>(blockIdx.x); ++q) c += counts[q];
#pragma unroll
      for (int r = 0; r < kChunkK; ++r) {
        c += (v[r] >> 16) & 1;
        v[r] = s0 + static_cast<int>(tbase) + r < window
                   ? (static_cast<unsigned>(c) << 16) | (v[r] & 0xFFFFu)
                   : fill_key<unsigned>();
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int r = 0; r < kChunkK; ++r) {
        const int s = s0 + static_cast<int>(tbase) + r;
        const long long g = start + s;
        v[r] = s >= window ? fill_key<Key>()
               : g < n ? (static_cast<Key>(k1[g] & 0xFFFFFFFFll) << 16) |
                             static_cast<Key>(w_in[g] & 0xFFFF)
                       : static_cast<Key>(kPadKey64);
      }
    }
    // stage kChunk runs descending in odd chunks of the window
    bitonic<Key, kChunkK, kChunkThreads, kLogChunk, 1>(v, sm, (v0 & kChunk) != 0);
  } else {
    shared_to_regs<Key, kChunkK>(v, scratch + v0);
    bitonic<Key, kChunkK, kChunkThreads, kLogChunk, kLogChunk>(v, sm, k < p2 && (v0 & k) != 0);
  }
  if (k == p2) {
    __syncthreads();
    regs_to_shared<Key, kChunkK>(sm, v);
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk; i += kChunkThreads) {
      const int s = s0 + i;
      const long long g = start + s;
      if (s < window && g < n) w_out[g] = static_cast<int>(sm[i] & 0xFFFFu);
    }
  } else {
    regs_to_shared<Key, kChunkK>(scratch + v0, v);
  }
}

// One compare-exchange stride (k, j) over every window's p2 keys in scratch.
template <typename Key>
__global__ void winsort_stride_kernel(Key* scratch, long long pairs, int p2, int k, int j) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < pairs; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = ((t & ~static_cast<long long>(j - 1)) << 1) | (t & (j - 1));
    const bool asc = ((i & (p2 - 1)) & k) == 0;
    Key a = scratch[i];
    Key b = scratch[i + j];
    cex(a, b, asc);
    scratch[i] = a;
    scratch[i + j] = b;
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// One pass of the chunked sort over `windows` windows starting at row
// offset; p2 > kChunk.
template <typename Key>
cudaError_t chunk_pass(const long long* k1, const int* w_in, int* w_out, Key* keys,
                       int* counts, long long n, int window, int p2, long long offset,
                       long long windows, cudaStream_t s) {
  const long long chunks = windows * (p2 / kChunk);
  const size_t smem = kChunk * sizeof(Key);
  auto first = winsort_chunk_kernel<Key, true>;
  auto later = winsort_chunk_kernel<Key, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(first, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(later, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (sizeof(Key) == 4)
    winsort_count_kernel<<<static_cast<unsigned>(chunks), 256, 0, s>>>(k1, n, window, p2,
                                                                         offset, counts);
  first<<<static_cast<unsigned>(chunks), kChunkThreads, smem, s>>>(
      k1, w_in, w_out, keys, counts, n, window, p2, offset, kChunk);
  const long long pairs = windows * p2 / 2;
  long long grid = (pairs + 255) / 256;
  if (grid > kStrideBlocks) grid = kStrideBlocks;
  for (int k = 2 * kChunk; k <= p2; k <<= 1) {
    for (int j = k >> 1; j >= kChunk; j >>= 1)
      winsort_stride_kernel<Key><<<static_cast<unsigned>(grid), 256, 0, s>>>(keys, pairs, p2, k, j);
    later<<<static_cast<unsigned>(chunks), kChunkThreads, smem, s>>>(
        k1, w_in, w_out, keys, counts, n, window, p2, offset, k);
  }
  return cudaGetLastError();
}

template <typename Key>
cudaError_t sort_chunked(const long long* k1, const int* w, int* out, void* scratch,
                         long long n, int window, int p2, long long windows, cudaStream_t s) {
  auto* keys = static_cast<Key*>(scratch);
  int* counts = reinterpret_cast<int*>(keys + windows * p2);
  cudaError_t err = chunk_pass<Key>(k1, w, out, keys, counts, n, window, p2, 0, windows, s);
  if (err == cudaSuccess && windows > 1)
    err = chunk_pass<Key>(k1, out, out, keys, counts, n, window, p2, window / 2, windows - 1, s);
  return err;
}

}  // namespace

// Scratch bytes pch_winsort needs: 0 where a window fits one block, else
// the first pass's padded keys (4 bytes each up to W 32,768, 8 above) and,
// for ranked keys, an int per chunk.
PCH_API long long pch_winsort_scratch(long long n, int window) {
  if (n <= 0 || window < 2) return 0;
  const int p2 = pow2_at_least(window);
  if (p2 <= kChunk) return 0;
  const long long windows = (n + window - 1) / window;
  if (window <= kMaxRanked)
    return windows * p2 * static_cast<long long>(sizeof(unsigned)) +
           windows * (p2 / kChunk) * static_cast<long long>(sizeof(int));
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
  const long long windows = (n + window - 1) / window;  // padded length / W
  cudaError_t err;
  if (p2 <= kChunk) err = sort_windows(k1, w, out, n, window, p2, windows, s);
  else if (window <= kMaxRanked)
    err = sort_chunked<unsigned>(k1, w, out, scratch, n, window, p2, windows, s);
  else
    err = sort_chunked<unsigned long long>(k1, w, out, scratch, n, window, p2, windows, s);
  return static_cast<int>(err);
}
