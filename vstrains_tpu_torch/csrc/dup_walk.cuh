// The classic probe's duplicate-run walk, shared by dup_stats.cu (dense
// engine) and dup_scan.cu (sparse engine).
//
// The JAX rule (vstrains_tpu/ops/pe_infer.py::_dup_scan_stats_impl and
// _sparse_expand_matches): a window (q1, h2, valid, lo) scans ranks
// d < D from loc = min(lo, M - 1); rank d matches when the window is valid,
// loc + d < M, and the entry at loc + d has h1 == q1 and h2 == h2.
//
// The table is sorted by h1 (signed, the order the join searches), its
// padding (h1 = INT32_MAX) last. So once an entry's h1 exceeds q1 no later
// rank can match, and the walk stops there: a window reads the entries of
// its equal-h1 run plus the first entry past it, min(run + 1, D, M - loc)
// in all (for any lo: entries below q1 are walked through). At the repeat
// cell's D = 32 that is ~2.4 entries a window where a thread a slot read 32.
// The walk loads entries in groups (2, then 4: most runs are one entry
// long, so the first group holds the run and its end).
#pragma once

#include "vt_common.cuh"

namespace vt {

constexpr int kWalkGroup = 4;  // entries a later group loads at once

// Calls hit(d, node) for each matching rank d of the walk over the n =
// min(D, M - loc) entries from loc, in rank order. The table is one
// interleaved 16-byte record (h1, h2, node, 0) an entry: one load serves
// the h1 test and the match.
template <class Hit>
__device__ __forceinline__ void walk(const int4* __restrict__ tab,
                                     int64_t loc, int n, int32_t q,
                                     int32_t h, Hit hit) {
  for (int d = 0, g = 2; d < n; d += g, g = kWalkGroup) {
    int4 e[kWalkGroup];
    bool past = false;
#pragma unroll
    for (int u = 0; u < kWalkGroup; ++u)
      e[u] = u < g && d + u < n ? __ldg(tab + loc + d + u)
                                : make_int4(0x7fffffff, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kWalkGroup; ++u) {
      const bool in = u < g && d + u < n;
      if (in && e[u].x == q && e[u].y == h) hit(d + u, e[u].z);
      past |= in && e[u].x > q;
    }
    if (past) return;
  }
}

// The position in shared memory at or after `at` whose address is
// congruent to `like`'s modulo 16 bytes, so that a flat range staged from
// there stores to `like` in 16-byte vectors.
__device__ __forceinline__ int32_t* congruent(int32_t* at,
                                              const int32_t* like) {
  const auto a = reinterpret_cast<uintptr_t>(at) >> 2;
  const auto b = reinterpret_cast<uintptr_t>(like) >> 2;
  return at + ((b - a) & 3);
}

// The first 16-byte boundary at or after p.
__device__ __forceinline__ int32_t* align16(int32_t* p) {
  return reinterpret_cast<int32_t*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t{15});
}

// Copies n int32 from shared src to global dst (congruent modulo 16
// bytes) with the whole block: a scalar head up to dst's first 16-byte
// boundary, 16-byte vectors, a scalar tail.
__device__ __forceinline__ void store_flat(int32_t* __restrict__ dst,
                                           const int32_t* src, int n) {
  const int head = min(
      n, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(dst) >> 2)) & 3));
  const int quads = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < quads; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + 4 * quads + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// Fills n int32 of shared memory from `at` with v, 16-byte stores over
// the aligned quads that cover it (callers leave room for the overhang).
__device__ __forceinline__ void fill_shared(int32_t* at, int n, int32_t v) {
  const auto a = reinterpret_cast<uintptr_t>(at);
  int4* p = reinterpret_cast<int4*>(a & ~uintptr_t{15});
  const int quads = static_cast<int>(
      ((a + 4 * static_cast<uintptr_t>(n) + 15) & ~uintptr_t{15}) -
      (a & ~uintptr_t{15})) >> 4;
  const int4 q = make_int4(v, v, v, v);
  for (int i = threadIdx.x; i < quads; i += blockDim.x) p[i] = q;
}

}  // namespace vt
