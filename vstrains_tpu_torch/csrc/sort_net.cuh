// The register-resident bitonic network shared by the row sorter
// (sort_rows.cu: rows, and the 16,384-word chunks of wider rows) and the
// column sorter (sort_cols.cu).
//
// One sequence of L = 32 * P * W words is held by W warps, P words a
// lane: in the "normal" layout register p of thread tid (= warp * 32 +
// lane) holds in-sequence index tid * P + p. A stride below P is a
// compare-exchange between two registers of one thread; a stride below
// one warp's span (32 P) is __shfl_xor_sync between lanes. Strides of a
// span and more (sequences of 1,024-16,384 words, P = 16) go through the
// sequence's shared-memory copy once per merge: the words are stored in
// the normal layout and read back in the "cube" layout (cube_index), where
// a thread's registers hold G words a span apart (cube_words: min(W, P),
// or 1), so the merge's strides of 1 to G / 2 spans (up to four) run in
// registers
// between two block barriers; a longer stride (8,192 in 16,384-word
// sequences) is one pairwise pass in shared memory before them.
//
// Shared memory is padded one word per 128 bytes (padded<Word>): a warp's
// normal-layout accesses (lane l at 32-bit word l * P + p) and its cube
// and coalesced accesses (32 consecutive words) fall in distinct banks.
#pragma once

#include "vt_common.cuh"

namespace vt {
namespace sortnet {

constexpr int kP = 16;                 // words a lane, sequences >= 512
constexpr int kMaxWarps = 32;          // 1,024 threads
constexpr int kMaxLen = 32 * kP * kMaxWarps;  // 16,384: one block's limit

__host__ __device__ constexpr int lg2(int n) {
  return n <= 1 ? 0 : 1 + lg2(n >> 1);
}

// a, b := (min, max) when asc, else (max, min): one compare, two selects
template <typename Word>
__device__ __forceinline__ void order(Word& a, Word& b, bool asc) {
  const bool swap = (b < a) == asc;
  const Word first = swap ? b : a;
  b = swap ? a : b;
  a = first;
}

// Shared-memory index of in-sequence slot i: one pad word per 128 bytes.
template <typename Word>
__host__ __device__ __forceinline__ int padded(int i) {
  return i + (i >> (sizeof(Word) == 4 ? 5 : 4));
}

template <typename Word>
__host__ __device__ constexpr int padded_len(int L) {
  return L + L / (sizeof(Word) == 4 ? 32 : 16);
}

// The words a thread holds a span apart in the cube layout, G: the long
// strides of a merge that run in its registers are 1 .. G / 2 spans. With
// G = 1 every long stride is a pairwise pass (one barrier each): 64-bit
// words in sequences of 2-8 warps keep those, which ran faster there than
// the cube, whose registers cost them occupancy.
template <typename Word, int P, int W>
__host__ __device__ constexpr int cube_words() {
  return sizeof(Word) == 8 && W < 16 ? 1 : (W < P ? W : P);
}

// In-sequence index of register m of thread tid in the cube layout
// (W > 1, so P = 16 and a span is 512 = 2^9 words). Index bits: 0-4 the
// lane; 5 .. 8 - g register bits m >> g and then the warp's low g bits;
// 9 .. 8 + g register bits m & (G - 1); 9 + g .. the warp's other bits.
template <typename Word, int P, int W>
__device__ __forceinline__ int cube_index(int tid, int m) {
  constexpr int kLgSpan = lg2(32 * P);
  constexpr int G = cube_words<Word, P, W>();
  constexpr int g = lg2(G);
  const int lane = tid & 31;
  const int wr = tid >> 5;
  return lane | ((m >> g) << 5) | ((wr & (G - 1)) << (kLgSpan - g)) |
         ((m & (G - 1)) << kLgSpan) | ((wr >> g) << (kLgSpan + g));
}

// The strides of a span and more of merge k (k > 32 P), through the
// sequence's shared copy s; every thread of the block takes part (block
// barriers). Directions are ascending where bit k of the index is 0,
// inverted by flip.
template <typename Word, int P, int W>
__device__ __forceinline__ void long_merge(Word (&x)[P], Word* s, int tid,
                                           int k, bool flip) {
  constexpr int L = 32 * P * W;
  constexpr int kSpan = 32 * P;
  constexpr int G = cube_words<Word, P, W>();
  constexpr int kCube = kSpan * G;  // strides below it are in registers
#pragma unroll
  for (int p = 0; p < P; ++p) s[padded<Word>(tid * P + p)] = x[p];
  __syncthreads();
  for (int j = k >> 1; j >= kCube; j >>= 1) {
    for (int t = tid; t < L / 2; t += 32 * W) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      Word a = s[padded<Word>(i)], b = s[padded<Word>(i + j)];
      order(a, b, ((i & k) == 0) != flip);
      s[padded<Word>(i)] = a;
      s[padded<Word>(i + j)] = b;
    }
    __syncthreads();
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int m = 0; m < P; ++m)
      x[m] = s[padded<Word>(cube_index<Word, P, W>(tid, m))];
#pragma unroll
    for (int j = (k >> 1) < (kCube >> 1) ? (k >> 1) : (kCube >> 1);
         j >= kSpan; j >>= 1) {
      const int d = j / kSpan;  // the partner's register distance
#pragma unroll
      for (int m = 0; m < P; ++m) {
        if (m & d) continue;
        order(x[m], x[m + d],
              ((cube_index<Word, P, W>(tid, m) & k) == 0) != flip);
      }
    }
#pragma unroll
    for (int m = 0; m < P; ++m)
      s[padded<Word>(cube_index<Word, P, W>(tid, m))] = x[m];
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < P; ++p) x[p] = s[padded<Word>(tid * P + p)];
}

// Merges kFirst, 2 kFirst, .. L of the network on the normal-layout
// registers x of thread tid (0 .. 32 W - 1 of its sequence): kFirst = 2
// sorts, kFirst = L merges one bitonic sequence. Ascending unless flip.
// With W == 1 no block barrier is reached (s unused).
template <typename Word, int P, int W, int kFirst>
__device__ __forceinline__ void net_sort(Word (&x)[P], Word* s, int tid,
                                         bool flip) {
  constexpr int L = 32 * P * W;
  constexpr int kSpan = 32 * P;
  const int lane = tid & 31;
  const int base = tid * P;
#pragma unroll
  for (int k = kFirst; k <= L; k <<= 1) {
    if (k > kSpan) long_merge<Word, P, W>(x, s, tid, k, flip);
#pragma unroll
    for (int j = (k >> 1) < (kSpan >> 1) ? (k >> 1) : (kSpan >> 1); j > 0;
         j >>= 1) {
      if (j >= P) {
        // partner lane ^ (j / P), same register; k > j >= P, so the
        // direction bit lies in base
        const bool keep_min =
            ((lane & (j / P)) == 0) == (((base & k) == 0) != flip);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const Word y = __shfl_xor_sync(0xffffffffu, x[p], j / P);
          if ((x[p] < y) != keep_min) x[p] = y;
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (p & j) continue;
          const bool asc = (k < P ? (p & k) == 0 : (base & k) == 0) != flip;
          order(x[p], x[p | j], asc);
        }
      }
    }
  }
}

}  // namespace sortnet
}  // namespace vt
