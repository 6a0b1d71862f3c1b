// Decoupled look-back: the carry between tiles of the one-launch scans
// (compactrows.cu, compactidx.cu, segscan.cu).
//
// A block takes its tile id from an atomic counter, so every tile before
// it has started and will publish.  Tiles publish 64-bit status words: a
// status in the high word and a 32-bit value in the low word, so a word is
// read whole or not at all and carries its own value (no fence needed).
// Warp 0 of a block reads its predecessors' words, 32 tiles a step.
//
// Two carries:
//   look_back      the sum of the counts before a tile (additive; words
//                  are aggregates or inclusive prefixes, one per tile);
//   seg_look_back  the (flag, value) state before a tile under segscan's
//                  right-dominant combine (fa, va).(fb, vb) =
//                  (fa | fb, fb ? vb : op(va, vb)), for C columns.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned kAggregate = 1;  // status flags (high word)
constexpr unsigned kInclusive = 2;

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          long long value) {
  return (static_cast<unsigned long long>(flag) << 32) |
         static_cast<unsigned>(value);
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(status) = word;
}

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* status) {
  return *reinterpret_cast<const volatile unsigned long long*>(status);
}

// The rows before `tile` kept in all, by warp 0: lane i reads the status of
// tile - 1 - i (spinning until it is published), and the warp adds the words
// up to the nearest inclusive prefix, 32 tiles a step.
__device__ long long look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long prefix = 0;
  for (int last = tile - 1;; last -= 32) {
    const int idx = last - lane;
    unsigned long long word = status_word(kInclusive, 0);  // before tile 0
    if (idx >= 0) {
      do {
        word = read_status(status + idx);
      } while ((word >> 32) == 0);
    }
    const unsigned incl = __ballot_sync(pch::kFullMask, (word >> 32) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(word & 0xFFFFFFFFull) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(pch::kFullMask, v, off);
    prefix += v;
    if (incl) return prefix;
  }
}

// ---- Segmented look-back.
//
// Every tile publishes its aggregate, one word per column:
//   agg[tile * C + c] = status_word(kAggregate | flag << 1, value bits),
// flag set when a segment starts inside the tile.  Everything before a
// segment start is dropped by the combine, so a flagged aggregate is as good
// as an inclusive prefix.  Anchor tiles (tile % 32 == 31) also publish their
// inclusive state in incl[(tile / 32) * C + c].
//
// The carry must be a fixed function of the input: a float sum over
// whichever words happen to be published already would round differently
// from run to run.  So tile t reads a fixed window, the aggregates of tiles
// [a, t) with a the anchor below t (a = 32 * floor(t / 32) - 1, or tile 0),
// and folds them in a fixed tree back to the nearest flagged one; only a
// window with no flag reads the anchor's inclusive word in place of its
// aggregate.  Each inclusive word is itself such a fold, so by induction
// every carry is.  A window holds at most 32 tiles (one warp read); a
// segment longer than 32 tiles chains from anchor to anchor.

__device__ __forceinline__ bool seg_flag(unsigned long long word) {
  return (word >> 33) & 1u;
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned bits) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(bits);
  } else {
    return static_cast<T>(bits);
  }
}

template <typename T>
__device__ __forceinline__ unsigned to_bits(T v) {
  if constexpr (std::is_same_v<T, float>) {
    return __float_as_uint(v);
  } else {
    return static_cast<unsigned>(v);
  }
}

template <typename T>
__device__ __forceinline__ unsigned long long seg_word(bool flag, T value) {
  return status_word(kAggregate | (flag ? 2u : 0u), to_bits(value));
}

template <int C>
__device__ __forceinline__ bool read_ready(const unsigned long long* src,
                                           unsigned long long (&w)[C]) {
  bool ready = true;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w[c] = read_status(src + c);
    ready &= (w[c] >> 32) != 0;
  }
  return ready;
}

// The state before `tile` (> 0), by all of warp 0.  Returns its flag and
// leaves its values in carry[] (in every lane).  OP(a, b) is op(a, b).
template <typename T, int C, typename OP>
__device__ bool seg_look_back(const unsigned long long* agg,
                              const unsigned long long* incl, int tile,
                              T (&carry)[C], OP op) {
  const int lane = threadIdx.x & 31;
  const int first = tile >= 32 ? (tile & ~31) - 1 : 0;
  const int wn = tile - first;  // 1..32 tiles; lane i holds tile - 1 - i
  const bool in = lane < wn;
  const unsigned long long* src = agg + static_cast<long long>(tile - 1 - lane) * C;
  unsigned long long w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) w[c] = 0;
  bool ready = !in;
  int stop;
  for (;;) {
    if (!ready) ready = read_ready<C>(src, w);
    const unsigned pending = ~__ballot_sync(pch::kFullMask, ready);
    const unsigned flagged = __ballot_sync(pch::kFullMask, in && ready && seg_flag(w[0]));
    const int first_pending = pending ? __ffs(pending) - 1 : 32;
    const int first_flag = flagged ? __ffs(flagged) - 1 : 32;
    if (first_flag < first_pending) {  // every nearer tile is known: stop there
      stop = first_flag + 1;
      break;
    }
    if (!pending) {  // no flag in the window: the anchor's inclusive word
      stop = wn;
      if (lane == wn - 1) {
        const unsigned long long* a = incl + static_cast<long long>(first >> 5) * C;
        while (!read_ready<C>(a, w)) {
        }
      }
      break;
    }
  }
  // fold lanes [0, stop) in tile order (lane i + d holds the earlier tile)
  bool f = lane < stop && seg_flag(w[0]);
  T v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = from_bits<T>(static_cast<unsigned>(w[c]));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool uf = __shfl_down_sync(pch::kFullMask, f, d);
    T uv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) uv[c] = __shfl_down_sync(pch::kFullMask, v[c], d);
    if (lane + d < stop) {
      if (!f) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = op(uv[c], v[c]);
      }
      f = f || uf;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = __shfl_sync(pch::kFullMask, v[c], 0);
  return __shfl_sync(pch::kFullMask, f, 0);
}

}  // namespace
