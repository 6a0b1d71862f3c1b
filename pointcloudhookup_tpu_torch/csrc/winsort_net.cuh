// Register bitonic networks for winsort.cu.
//
// A block of THREADS threads holds S = THREADS * K keys, thread t the K
// consecutive slots [t K, t K + K) in registers.  The slots form
// independent segments of SEG keys.  Strides below K are compare-exchanges
// inside a thread, strides of K .. 16 K are shuffles between lanes, and
// only strides of 32 K and more go through shared memory, with a barrier
// a stride.  Every stage, stride and direction is a compile-time constant
// of the unrolled loops, so no index needs a division.
#pragma once

#include "common.cuh"

namespace {

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <typename Key>
__device__ __forceinline__ void cex(Key& a, Key& b, bool asc) {
  const Key lo = a < b ? a : b;
  const Key hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// v -> sm[t K .. t K + K), in 16-byte stores
template <typename Key, int K>
__device__ __forceinline__ void regs_to_shared(Key* sm, const Key (&v)[K]) {
  Key* p = sm + threadIdx.x * K;
  if constexpr (sizeof(Key) == 4 && K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4)
      *reinterpret_cast<uint4*>(p + r) = make_uint4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  } else if constexpr (sizeof(Key) == 8 && K % 2 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 2)
      *reinterpret_cast<ulonglong2*>(p + r) = make_ulonglong2(v[r], v[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) p[r] = v[r];
  }
}

template <typename Key, int K>
__device__ __forceinline__ void shared_to_regs(Key (&v)[K], const Key* sm) {
  const Key* p = sm + threadIdx.x * K;
  if constexpr (sizeof(Key) == 4 && K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + r);
      v[r] = q.x; v[r + 1] = q.y; v[r + 2] = q.z; v[r + 3] = q.w;
    }
  } else if constexpr (sizeof(Key) == 8 && K % 2 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 2) {
      const ulonglong2 q = *reinterpret_cast<const ulonglong2*>(p + r);
      v[r] = q.x; v[r + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = p[r];
  }
}

// Bitonic stages k = 2**LK_LO .. SEG, each with strides j = k/2 .. 1.  Slot
// i sorts ascending in stage k < SEG iff bit k of i is 0, and in stage SEG
// iff !top_desc (so LK_LO = log2(SEG) is a merge of bitonic SEG-key
// segments, in one direction).  sm: S keys of shared scratch, used only
// where SEG > 32 K; the caller synchronises before sm is reused.
template <typename Key, int K, int THREADS, int LOG_SEG, int LK_LO>
__device__ __forceinline__ void bitonic(Key (&v)[K], Key* sm, bool top_desc) {
  constexpr int kWarpSlots = 32 * K;
  constexpr int LOG_K = ilog2(K);
  constexpr int LOG_WS = LOG_K + 5;
  constexpr int SEG = 1 << LOG_SEG;
  const unsigned tbase = threadIdx.x * K;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lk = LK_LO; lk <= LOG_SEG; ++lk) {
    const int k = 1 << lk;
    if (k > kWarpSlots) {
      regs_to_shared<Key, K>(sm, v);
      __syncthreads();
#pragma unroll
      for (int lj = lk - 1; lj >= LOG_WS; --lj) {
        const int j = 1 << lj;
#pragma unroll
        for (int q = 0; q < K / 2; ++q) {
          const unsigned p = threadIdx.x + q * THREADS;
          const unsigned i = ((p & ~(j - 1u)) << 1) | (p & (j - 1u));
          const bool asc = k == SEG ? !top_desc : (i & k) == 0;
          Key a = sm[i], b = sm[i + j];
          cex(a, b, asc);
          sm[i] = a;
          sm[i + j] = b;
        }
        __syncthreads();
      }
      shared_to_regs<Key, K>(v, sm);
    }
#pragma unroll
    for (int lj = (lk < LOG_WS ? lk : LOG_WS) - 1; lj >= LOG_K; --lj) {
      const int j = 1 << lj;
      const int s = j / K;  // lane distance
      const bool asc = k == SEG ? !top_desc : (tbase & k) == 0;
      const bool keep_min = ((lane & s) == 0) == asc;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const Key p = __shfl_xor_sync(pch::kFullMask, v[r], s);
        v[r] = keep_min ? (v[r] < p ? v[r] : p) : (v[r] < p ? p : v[r]);
      }
    }
#pragma unroll
    for (int lj = (lk < LOG_K ? lk : LOG_K) - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if ((r & j) == 0) {
          const bool asc = k == SEG ? !top_desc : ((tbase + r) & k) == 0;
          cex(v[r], v[r + j], asc);
        }
      }
    }
  }
}

}  // namespace
