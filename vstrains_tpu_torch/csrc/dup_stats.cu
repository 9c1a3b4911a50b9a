// The classic probe's per-(read, node) stats on the dense engine: the
// duplicate-run walk fused with the hit count and lowest window index.
//
// Replaces vstrains_tpu/ops/pe_infer.py::_dup_scan_stats_impl (an XLA
// stage of the JAX package, no Pallas kernel there), which the port used
// to run as dup_scan's [R, K * D] slot plane written to device memory and
// read back by stats_accum.
//
// Inputs, per window w of R x K (row-major): the biased primary hash
// q1[w], the secondary hash h2[w], valid[w] and lo[w], the first table
// position with h1 >= q1 (a join, a binary search or the bucket lookup,
// which gives M for a window it does not find); the padded table, sorted by
// h1, as interleaved records int32 [M, 4] (dup_walk.cuh).
// Outputs, int32 [R, N]:
//   cnt[r, n]  = the matches of row r's windows at node n,
//   kmin[r, n] = the lowest window index k of those, INT32_MAX where cnt
//                is 0,
// with the JAX rule exactly (dup_walk.cuh); node ids outside [0, N) are
// dropped.
//
// What bounds it on the card: bytes. It reads 13 bytes a window and the
// entries its walk needs, and writes 8 * N bytes a row: at the repeat
// cell's 2B = 32,768, K = 95, N = 1,024 the outputs (268 MB) are most of
// it, against 0.40 GB each way for the slot plane it replaces. Design: a
// block owns `rows` consecutive rows (about 256 windows), one thread a
// window. The rows' counters live in shared memory (dynamic above 48 KB,
// up to the 227 KB a block may take), laid out as the rows' flat range of
// the outputs and placed congruent with it modulo 16 bytes, so that after
// the walks (one shared atomicAdd and atomicMin a match; integer atomics
// are exact in any order) the block writes its rows out once in 16-byte
// stores. Past the shared budget the block zeroes its rows in device
// memory and runs the same atomics there. All per-window arithmetic is in
// 32-bit block-local indices over one 64-bit base a block.

#include "dup_walk.cuh"

namespace {

constexpr int kWindows = 256;          // windows a block aims for
constexpr int kMaxThreads = 1024;
constexpr int64_t kSmemMax = 227 * 1024;

struct Plan {
  int rows, threads;
  int64_t smem;  // bytes of shared counters, 0 for the global branch
};

// shared words for `rows` rows' counters: two flat ranges, each placed
// congruent with its output and padded to whole 16-byte quads
int64_t smem_bytes(int64_t rows, int64_t N) {
  return 4 * (2 * rows * N + 16);
}

Plan plan(int64_t R, int64_t K, int64_t N) {
  int64_t rows = K >= kWindows ? 1 : kWindows / (K > 0 ? K : 1);
  if (rows > R) rows = R;
  while (rows > 1 && smem_bytes(rows, N) > kSmemMax) --rows;
  const int64_t smem = smem_bytes(rows, N) <= kSmemMax ? smem_bytes(rows, N)
                                                       : 0;
  int64_t threads = (rows * K + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return {static_cast<int>(rows), static_cast<int>(threads), smem};
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
dup_stats_kernel(const int32_t* __restrict__ q1,
                 const int32_t* __restrict__ h2,
                 const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ lo,
                 const int4* __restrict__ tab, int64_t M,
                 int64_t R, int K, int D, int N, int rows_per_block,
                 int32_t* __restrict__ cnt, int32_t* __restrict__ kmin) {
  extern __shared__ int4 s_raw[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      R - r0 < rows_per_block ? R - r0 : rows_per_block);
  const int span = rows * N;
  int32_t* c = cnt + r0 * N;
  int32_t* km = kmin + r0 * N;
  if (kShared) {
    int32_t* base = reinterpret_cast<int32_t*>(s_raw);
    int32_t* sc = vt::congruent(base, c);
    int32_t* sk = vt::congruent(vt::align16(sc + span), km);
    vt::fill_shared(sc, span, 0);
    vt::fill_shared(sk, span, vt::kInf);
    c = sc;
    km = sk;
  } else {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      c[i] = 0;
      km[i] = vt::kInf;
    }
  }
  // the barrier also makes the global branch's zeroing visible to the block
  __syncthreads();
  const int64_t w0 = r0 * K;
  for (int wl = threadIdx.x; wl < rows * K; wl += blockDim.x) {
    const int64_t w = w0 + wl;
    const int32_t q = __ldg(q1 + w);
    const int32_t h = __ldg(h2 + w);
    const int64_t l = __ldg(lo + w);
    if (!__ldg(valid + w)) continue;
    const int64_t loc = l < M - 1 ? l : M - 1;
    const int n = static_cast<int>(M - loc < D ? M - loc : D);
    const int rl = wl / K;
    const int k = wl - rl * K;
    int32_t* crow = c + rl * N;
    int32_t* krow = km + rl * N;
    vt::walk(tab, loc, n, q, h, [&](int, int32_t node) {
      if (static_cast<uint32_t>(node) < static_cast<uint32_t>(N)) {
        atomicAdd(&crow[node], 1);
        atomicMin(&krow[node], k);
      }
    });
  }
  if (kShared) {
    __syncthreads();
    vt::store_flat(cnt + r0 * N, c, span);
    vt::store_flat(kmin + r0 * N, km, span);
  }
}

}  // namespace

VT_EXPORT int vt_dup_stats(const void* q1, const void* h2, const void* valid,
                           const void* lo, const void* tab, int64_t R,
                           int64_t K, int64_t D, int64_t M, int64_t N,
                           void* cnt, void* kmin, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || D <= 0 || M <= 0 || K > 0x7fffffff || D > 0x7fffffff ||
      N > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(R, K, N);
  const unsigned grid = static_cast<unsigned>((R + p.rows - 1) / p.rows);
  const auto* a = static_cast<const int32_t*>(q1);
  const auto* b = static_cast<const int32_t*>(h2);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* l = static_cast<const int32_t*>(lo);
  const auto* t = static_cast<const int4*>(tab);
  auto* c = static_cast<int32_t*>(cnt);
  auto* km = static_cast<int32_t*>(kmin);
  const int k = static_cast<int>(K), d = static_cast<int>(D),
            n = static_cast<int>(N);
  if (p.smem) {
    const cudaError_t err = vt::allow_smem(dup_stats_kernel<true>, p.smem);
    if (err != cudaSuccess) return err;
    dup_stats_kernel<true><<<grid, p.threads, p.smem, s>>>(
        a, b, v, l, t, M, R, k, d, n, p.rows, c, km);
  } else {
    dup_stats_kernel<false><<<grid, p.threads, 0, s>>>(
        a, b, v, l, t, M, R, k, d, n, p.rows, c, km);
  }
  return cudaGetLastError();
}
