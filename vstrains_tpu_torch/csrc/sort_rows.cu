// Row-wise ascending sort of int32 [R, C] by (key, val), or by key alone.
//
// Replaces vstrains_tpu/ops/pallas_sort.py::sort_rows_pallas (kernel
// _rowsort_kernel, the roll-based bitonic network) and the jax.lax.sort
// row sorts of the sparse PE tail (ops/pe_infer.py::_row_run_stats and
// _sort_compact_runs). The column sorter prototype
// tools/colsort_proto.py::sort_cols_pallas is sort_cols.cu.
//
// Words: a (key, val) slot is one 64-bit word (key ^ 0x80000000) << 32 |
// (val ^ 0x80000000), so an unsigned compare is the signed (key, val)
// order and key and value move together; a key-only slot is the 32-bit
// word key ^ 0x80000000. A row pads to L = the next power of two >= C
// (at least 32) with all-ones words, which sort last and are never
// written back (an all-ones word equals a real INT32_MAX slot, so which
// of the two lands in the tail does not change the output).
//
// What bounds it on the card: device memory sees every slot once in and
// once out, 74.7 MB key-only and 149.4 MB (key, val) at the N = 50k tail's
// 32,768 x 285, i.e. 0.022 and 0.045 ms at 3.35 TB/s (H100 SXM published
// peak at 700 W). The bitonic network's log2(L) * (log2(L) + 1) / 2
// exchange stages (45 at L = 512, 105 at 16,384) are the work in between,
// and they bound it: they run in registers (sort_net.cuh), where a 64-bit
// compare-exchange costs two compares and four selects against one
// compare and two selects for a 32-bit word, and each shuffle stage
// moves a 64-bit word as two shuffles. Design:
//   * Network branch (L <= 16,384): one row in the registers of one
//     block, P = 16 consecutive words per lane (P = L / 32 for L < 512),
//     W = L / 512 warps per row (up to 32: 1,024 threads); strides of 512
//     and more go through the row's shared copy, up to four of a merge
//     between two barriers, or for (key, val) rows of 2-8 warps as one
//     pairwise pass a stride (sort_net.cuh). Rows up to 512 slots are one
//     warp each, eight to a block, with no block barrier at all. The
//     shared copy of a 16,384-slot (key, val) row is 139 KB: the kernel
//     opts into that much dynamic shared memory before it launches, and a
//     refused opt-in is returned as the launch's error.
//   * Loads give lane l of warp w slot w * 32P + 32p + l in register p
//     (coalesced; the input order of a sort is free); pad words are made
//     in registers, never loaded. The sorted row leaves through shared
//     memory (padded one word per 128 bytes, so the strided writes do not
//     conflict) and is stored coalesced, slots >= C never written.
//   * Indexing is per row (row * C + slot) from the block and lane ids:
//     no division in the load or store loops.
//   * Global branch (L > 16,384): rows too wide for one block, sorted
//     through a scratch buffer of R * L words. The same one-block network
//     sorts every 16,384-word chunk of a row, chunks alternately
//     ascending and descending (sort_chunk); then for each merge size m >
//     16,384 the strides m / 2 .. 16,384 run as global passes, up to four
//     strides a pass (a thread holds 2^s words at stride j / 2^(s-1)),
//     and the strides below run in the one-block network chunk by chunk;
//     the last merge writes the outputs. A second code path for a size
//     the first cannot hold, not a fallback.

#include "sort_net.cuh"

namespace {

using vt::sortnet::kMaxLen;
using vt::sortnet::net_sort;
using vt::sortnet::padded;
using vt::sortnet::padded_len;

constexpr int kChunkLg = vt::sortnet::lg2(kMaxLen);

__device__ __forceinline__ uint64_t pack(int32_t k, int32_t v) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(k) ^ 0x80000000u)
          << 32) |
         (static_cast<uint32_t>(v) ^ 0x80000000u);
}

// The word of slot o of the inputs, and its way back.
__device__ __forceinline__ void load_word(uint32_t& w, const int32_t* key,
                                          const int32_t*, int64_t o) {
  w = static_cast<uint32_t>(key[o]) ^ 0x80000000u;
}

__device__ __forceinline__ void load_word(uint64_t& w, const int32_t* key,
                                          const int32_t* val, int64_t o) {
  w = pack(key[o], val[o]);
}

__device__ __forceinline__ void store_word(uint32_t w, int32_t* key_out,
                                           int32_t*, int64_t o) {
  key_out[o] = static_cast<int32_t>(w ^ 0x80000000u);
}

__device__ __forceinline__ void store_word(uint64_t w, int32_t* key_out,
                                           int32_t* val_out, int64_t o) {
  key_out[o] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32) ^
                                    0x80000000u);
  val_out[o] = static_cast<int32_t>(static_cast<uint32_t>(w) ^ 0x80000000u);
}

// One row of L = 32 * P * W words: W warps, P consecutive words a lane.
// Rows with W == 1 are eight to a block, a warp each; wider rows are one
// to a block.
template <typename Word, int P, int W>
__device__ __forceinline__ void sort_row(const int32_t* __restrict__ key,
                                         const int32_t* __restrict__ val,
                                         int64_t R, int C,
                                         int32_t* __restrict__ key_out,
                                         int32_t* __restrict__ val_out) {
  constexpr int L = 32 * P * W;
  constexpr int kSpan = 32 * P;  // one warp's words
  constexpr Word kPadWord = static_cast<Word>(~0ull);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = W == 1 ? 0 : warp;  // warp within the row
  const int tid = wr * 32 + lane;    // thread within the row
  const int64_t row =
      W == 1 ? static_cast<int64_t>(blockIdx.x) * 8 + warp : blockIdx.x;
  if (row >= R) return;  // W == 1 only: no block barrier follows
  Word* s = reinterpret_cast<Word*>(smem_raw) +
            (W == 1 ? warp * padded_len<Word>(L) : 0);
  const int64_t g = row * C;
  const int base = tid * P;

  Word x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = wr * kSpan + p * 32 + lane;
    x[p] = kPadWord;
    if (e < C) load_word(x[p], key, val, g + e);
  }
  net_sort<Word, P, W, 2>(x, s, tid, false);

  // out through shared memory: the first C sorted slots, coalesced (a
  // thread rewrites only its own slots, which it alone has read since)
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (base + p < C) s[padded<Word>(base + p)] = x[p];
  if (W == 1)
    __syncwarp();
  else
    __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = wr * kSpan + p * 32 + lane;
    if (e < C) store_word(s[padded<Word>(e)], key_out, val_out, g + e);
  }
}

template <typename Word, int P, int W>
__global__ void __launch_bounds__(W == 1 ? 256 : 32 * W)
sort_rows_net(const int32_t* __restrict__ key, const int32_t* __restrict__ val,
              int64_t R, int C, int32_t* __restrict__ key_out,
              int32_t* __restrict__ val_out) {
  sort_row<Word, P, W>(key, val, R, C, key_out, val_out);
}

// Rows of 16 warps, held to two blocks an SM (64 registers a thread),
// where (key, val) words would take 112 registers and one.
template <typename Word>
__global__ void __launch_bounds__(512, 2)
sort_rows_net16(const int32_t* __restrict__ key,
                const int32_t* __restrict__ val, int64_t R, int C,
                int32_t* __restrict__ key_out, int32_t* __restrict__ val_out) {
  sort_row<Word, 16, 16>(key, val, R, C, key_out, val_out);
}

template <typename Word, int P, int W>
cudaError_t launch_net(const int32_t* k, const int32_t* v, int64_t R,
                       int64_t C, int32_t* ko, int32_t* vo, cudaStream_t s) {
  constexpr int rows_per_block = W == 1 ? 8 : 1;
  const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem =
      rows_per_block * padded_len<Word>(32 * P * W) * sizeof(Word);
  const auto kernel = [] {
    if constexpr (W == 16)
      return sort_rows_net16<Word>;
    else
      return sort_rows_net<Word, P, W>;
  }();
  const cudaError_t err = vt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), 32 * W * rows_per_block, smem, s>>>(
      k, v, R, static_cast<int>(C), ko, vo);
  return cudaGetLastError();
}

template <typename Word>
cudaError_t launch_net_for(int64_t L, const int32_t* k, const int32_t* v,
                           int64_t R, int64_t C, int32_t* ko, int32_t* vo,
                           cudaStream_t s) {
  switch (L) {
    case 32: return launch_net<Word, 1, 1>(k, v, R, C, ko, vo, s);
    case 64: return launch_net<Word, 2, 1>(k, v, R, C, ko, vo, s);
    case 128: return launch_net<Word, 4, 1>(k, v, R, C, ko, vo, s);
    case 256: return launch_net<Word, 8, 1>(k, v, R, C, ko, vo, s);
    case 512: return launch_net<Word, 16, 1>(k, v, R, C, ko, vo, s);
    case 1024: return launch_net<Word, 16, 2>(k, v, R, C, ko, vo, s);
    case 2048: return launch_net<Word, 16, 4>(k, v, R, C, ko, vo, s);
    case 4096: return launch_net<Word, 16, 8>(k, v, R, C, ko, vo, s);
    case 8192: return launch_net<Word, 16, 16>(k, v, R, C, ko, vo, s);
    case 16384: return launch_net<Word, 16, 32>(k, v, R, C, ko, vo, s);
    default: return cudaErrorInvalidValue;
  }
}

// Global branch: one chunk of kMaxLen words of the padded [R, L] array
// (L = 2^lg_chunks chunks of a row), block b = chunk b. kFirst == 2: the
// chunk sort, from the int32 inputs (any order, pads made in registers),
// ascending for even chunks and descending for odd ones (the directions
// of merge kMaxLen in the row); kFirst == kMaxLen: the in-chunk strides
// of merge `merge`, from the scratch words, ascending where bit `merge`
// of the in-row index is 0. Destination: the scratch words (dst), or the
// int32 outputs (dst == nullptr, the last merge).
template <typename Word, int kFirst>
__global__ void __launch_bounds__(kMaxLen / 16)
sort_chunk(const int32_t* __restrict__ key, const int32_t* __restrict__ val,
           int64_t C, int lg_chunks, const Word* src, Word* dst,
           int32_t* __restrict__ key_out, int32_t* __restrict__ val_out,
           int64_t merge) {
  constexpr int P = vt::sortnet::kP;
  constexpr int W = vt::sortnet::kMaxWarps;
  constexpr int kSpan = 32 * P;
  constexpr Word kPadWord = static_cast<Word>(~0ull);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Word* s = reinterpret_cast<Word*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t r = b >> lg_chunks;
  const int64_t c0 = (b & ((int64_t{1} << lg_chunks) - 1)) << kChunkLg;
  const int64_t g = b << kChunkLg;  // the chunk's first scratch word

  Word x[P];
  bool flip;
  if constexpr (kFirst == 2) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int e = wr * kSpan + p * 32 + lane;
      x[p] = kPadWord;
      if (c0 + e < C) load_word(x[p], key, val, r * C + c0 + e);
    }
    flip = (c0 & kMaxLen) != 0;
  } else {
    // the merge needs each word at its index: in coalesced, then out of
    // shared memory in the normal layout
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int e = wr * kSpan + p * 32 + lane;
      s[padded<Word>(e)] = src[g + e];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < P; ++p) x[p] = s[padded<Word>(tid * P + p)];
    flip = (c0 & merge) != 0;
  }
  net_sort<Word, P, W, kFirst>(x, s, tid, flip);

#pragma unroll
  for (int p = 0; p < P; ++p) s[padded<Word>(tid * P + p)] = x[p];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = wr * kSpan + p * 32 + lane;
    const Word w = s[padded<Word>(e)];
    if (dst != nullptr)
      dst[g + e] = w;
    else if (c0 + e < C)
      store_word(w, key_out, val_out, r * C + c0 + e);
  }
}

// Strides j, j / 2, .. j / 2^(S-1) of merge m over the whole scratch
// array of `words` words (rows of L): thread t holds the 2^S words
// b + q * (j / 2^(S-1)), b = t with S zero bits inserted at the shortest
// stride's bit; consecutive threads read consecutive words.
template <typename Word, int S>
__global__ void __launch_bounds__(256)
sort_global_pass(Word* __restrict__ w, int64_t words, int64_t L, int64_t j,
                 int64_t m) {
  constexpr int Q = 1 << S;
  const int64_t jl = j >> (S - 1);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < (words >> S); t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t lo = t & (jl - 1);
    const int64_t b = ((t - lo) << S) | lo;
    const bool asc = (b & (L - 1) & m) == 0;
    Word v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = w[b + q * jl];
#pragma unroll
    for (int d = Q / 2; d > 0; d >>= 1)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (!(q & d)) vt::sortnet::order(v[q], v[q + d], asc);
#pragma unroll
    for (int q = 0; q < Q; ++q) w[b + q * jl] = v[q];
  }
}

template <typename Word>
cudaError_t launch_pass(int S, Word* w, int64_t words, int64_t L, int64_t j,
                        int64_t m, cudaStream_t s) {
  const int64_t blocks64 = ((words >> S) + 255) / 256;
  const unsigned blocks =
      static_cast<unsigned>(blocks64 < (1 << 20) ? blocks64 : (1 << 20));
  auto pass = S == 1   ? sort_global_pass<Word, 1>
              : S == 2 ? sort_global_pass<Word, 2>
              : S == 3 ? sort_global_pass<Word, 3>
                       : sort_global_pass<Word, 4>;
  pass<<<blocks, 256, 0, s>>>(w, words, L, j, m);
  return cudaGetLastError();
}

template <typename Word>
cudaError_t sort_global(const int32_t* k, const int32_t* v, int64_t R,
                        int64_t C, int lg_l, int32_t* ko, int32_t* vo,
                        Word* w, cudaStream_t s) {
  const int64_t L = int64_t{1} << lg_l;
  const int lg_chunks = lg_l - kChunkLg;
  const int64_t chunks = R << lg_chunks;
  if (chunks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(chunks);
  constexpr int kThreads = kMaxLen / 16;
  const size_t smem = padded_len<Word>(kMaxLen) * sizeof(Word);
  cudaError_t err = vt::allow_smem(sort_chunk<Word, 2>, smem);
  if (err == cudaSuccess)
    err = vt::allow_smem(sort_chunk<Word, kMaxLen>, smem);
  if (err != cudaSuccess) return err;
  sort_chunk<Word, 2><<<blocks, kThreads, smem, s>>>(
      k, v, C, lg_chunks, nullptr, w, nullptr, nullptr, 0);
  err = cudaGetLastError();
  for (int64_t m = 2 * kMaxLen; m <= L && err == cudaSuccess; m <<= 1) {
    int left = vt::sortnet::lg2(static_cast<int>(m >> kChunkLg));
    for (int64_t j = m >> 1; left > 0 && err == cudaSuccess;) {
      const int S = left < 4 ? left : 4;
      err = launch_pass(S, w, R * L, L, j, m, s);
      j >>= S;
      left -= S;
    }
    const bool last = m == L;
    sort_chunk<Word, kMaxLen><<<blocks, kThreads, smem, s>>>(
        nullptr, nullptr, C, lg_chunks, w, last ? nullptr : w,
        last ? ko : nullptr, last ? vo : nullptr, m);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  return err;
}

int lg2_at_least(int64_t c) {
  int lg = 0;
  while ((int64_t{1} << lg) < c) ++lg;
  return lg;
}

}  // namespace

// 1 when rows of padded width L sort in one block's register network, 0
// for the global branch (which needs a scratch buffer of R * L words: 8
// bytes a word with values, 4 key-only).
VT_EXPORT int vt_sort_rows_uses_network(int64_t L) { return L <= kMaxLen; }

VT_EXPORT int vt_sort_rows(const void* key, const void* val, int64_t R,
                           int64_t C, void* key_out, void* val_out,
                           void* scratch, void* stream) {
  if (R <= 0 || C <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(key);
  const auto* v = static_cast<const int32_t*>(val);
  auto* ko = static_cast<int32_t*>(key_out);
  auto* vo = static_cast<int32_t*>(val_out);
  const int lg_l = lg2_at_least(C);
  const int64_t L = int64_t{1} << lg_l;
  if (vt_sort_rows_uses_network(L)) {
    const int64_t Lw = L < 32 ? 32 : L;
    return v == nullptr
               ? launch_net_for<uint32_t>(Lw, k, v, R, C, ko, vo, s)
               : launch_net_for<uint64_t>(Lw, k, v, R, C, ko, vo, s);
  }
  if (scratch == nullptr || C > 0x7fffffff) return cudaErrorInvalidValue;
  return v == nullptr
             ? sort_global(k, v, R, C, lg_l, ko, vo,
                           static_cast<uint32_t*>(scratch), s)
             : sort_global(k, v, R, C, lg_l, ko, vo,
                           static_cast<uint64_t*>(scratch), s);
}
