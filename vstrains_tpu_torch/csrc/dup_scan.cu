// The classic probe's duplicate-run scan: per-slot matched node ids.
//
// The port's own kernel for an XLA stage of the JAX package (no Pallas
// kernel there): ops/pe_infer.py::_gather_node_slots, which feeds the
// stats accumulator, and its sparse twin _sparse_expand_matches.
//
// Inputs, per window w of R x K (row-major): the biased primary hash
// q1[w], the secondary hash h2[w], valid[w], and lo[w], the window's first
// table position with h1 >= q1 (a join, a binary search or the bucket
// lookup; the lookup gives M for a window it does not find). The table
// (h1 sorted, h2, node; int32 [M], M the padded length, sentinel entries
// h1 = INT32_MAX, h2 = -1, node 0) is the JAX package's padded table.
// Output: int32 [R, K * D], slot w * D + d holding tab_node[idx] when the
// window matches at duplicate rank d, else the sentinel N, with the JAX
// rule exactly:
//   loc = min(lo, M - 1), idx = min(loc + d, M - 1),
//   match = valid && tab_h1[idx] == q1 && tab_h2[idx] == h2
//           && loc + d < M.
//
// What bounds it on the card: bytes. It reads each window's four inputs
// (13 bytes) and writes 4 * D bytes a window; the table reads are gathers,
// one 32-byte sector a window and rank group at most, from a table that
// at the repeat cell's 1 M entries sits in L2 and at 300,000 nodes
// (1.6 GB) does not. At 2B = 32,768, K = 95, D = 32 the output, 0.40 GB,
// is nearly all of it. Design, simple first: one thread a slot, so a
// warp's stores are 128 contiguous bytes; the D ranks of a window are
// neighbouring threads reading neighbouring table entries, and the
// window's inputs are the same address for all of them (broadcast). A
// thread keeps kSlots slots of its grid stride in flight, and each slot's
// loads come in three rounds: the window's four inputs, the entry's
// primary hash, then the secondary hash and the node together for primary
// matches only (most ranks of a scan lie past the window's run, so an
// unconditional secondary hash doubles the table bytes). It runs well
// below its bound (PERF.md §6); fusing it into stats_accum is the next
// step. Plain torch would materialise an int64 index plane and three
// gathered planes of [R * K, D] per batch.

#include "vt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;                 // slots a thread keeps in flight
constexpr int64_t kMaxBlocks = 132 * 64;  // a grid-stride loop beyond

// Index is uint32_t while the slots fit it (the paths' shapes: 2B x K x D
// stays under 2^31) and int64_t past that; the window of a slot is one
// division by the depth either way.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
dup_scan_kernel(const int32_t* __restrict__ q1, const int32_t* __restrict__ h2,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ lo,
                const int32_t* __restrict__ tab_h1,
                const int32_t* __restrict__ tab_h2,
                const int32_t* __restrict__ tab_node, Index slots,
                Index depth, int64_t M, int32_t N,
                int32_t* __restrict__ out) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index first = static_cast<Index>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       first < slots; first += stride * kSlots) {
    int64_t pos[kSlots];
    int32_t want1[kSlots], want2[kSlots];
    bool live[kSlots];
    // round 1: the windows' inputs (a slot past the end reads window 0)
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const Index s = first + u * stride;
      const Index w = s < slots ? s / depth : 0;
      const int64_t l = __ldg(lo + w);
      want1[u] = __ldg(q1 + w);
      want2[u] = __ldg(h2 + w);
      pos[u] = (l < M - 1 ? l : M - 1) + static_cast<int64_t>(s - w * depth);
      live[u] = s < slots && __ldg(valid + w) && pos[u] < M;
    }
    // round 2: the entries' primary hashes
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (live[u]) live[u] = __ldg(tab_h1 + pos[u]) == want1[u];
    // round 3: secondary hash and node where the primary matched, then the
    // stores
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      int32_t node = N;
      if (live[u]) {
        const int32_t e2 = __ldg(tab_h2 + pos[u]);
        const int32_t e_node = __ldg(tab_node + pos[u]);
        if (e2 == want2[u]) node = e_node;
      }
      const Index s = first + u * stride;
      if (s < slots) out[s] = node;
    }
  }
}

}  // namespace

VT_EXPORT int vt_dup_scan(const void* q1, const void* h2, const void* valid,
                          const void* lo, const void* tab_h1,
                          const void* tab_h2, const void* tab_node,
                          int64_t windows, int64_t depth, int64_t M,
                          int64_t N, void* out, void* stream) {
  if (windows <= 0 || depth <= 0) return cudaSuccess;
  if (M <= 0 || N < 0 || N > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t slots = windows * depth;
  int64_t blocks = (slots + kThreads * kSlots - 1) / (kThreads * kSlots);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(q1);
  const auto* b = static_cast<const int32_t*>(h2);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* l = static_cast<const int32_t*>(lo);
  const auto* t1 = static_cast<const int32_t*>(tab_h1);
  const auto* t2 = static_cast<const int32_t*>(tab_h2);
  const auto* tn = static_cast<const int32_t*>(tab_node);
  auto* o = static_cast<int32_t*>(out);
  const auto n = static_cast<int32_t>(N);
  // the uint32 loop's last step must not wrap: slots + kSlots strides
  // stay under 2^32
  if (slots + kSlots * kMaxBlocks * kThreads < (int64_t{1} << 32)) {
    dup_scan_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(a, b, v, l, t1, t2, tn,
                                     static_cast<uint32_t>(slots),
                                     static_cast<uint32_t>(depth), M, n, o);
  } else {
    dup_scan_kernel<int64_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, b, v, l, t1, t2, tn, slots, depth, M,
                                    n, o);
  }
  return cudaGetLastError();
}
