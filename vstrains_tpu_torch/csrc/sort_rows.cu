// Row-wise ascending sort of int32 [R, C] by (key, val), or by key alone.
//
// Replaces vstrains_tpu/ops/pallas_sort.py::sort_rows_pallas (kernel
// _rowsort_kernel, the roll-based bitonic network) and the jax.lax.sort
// row sorts of the sparse PE tail (ops/pe_infer.py::_row_run_stats and
// _sort_compact_runs); key-only on the transpose it also stands for the
// column sorter prototype tools/colsort_proto.py::sort_cols_pallas.
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
// peak at 700 W). The bitonic network's log2(L) * (log2(L) + 1) / 2 = 45
// exchange stages at L = 512 are the work in between, and they bound it:
// the earlier design ran all 45 through shared memory with a block
// barrier after each; here they run in registers, where a 64-bit
// compare-exchange costs two compares and four selects against one
// compare and two selects for a 32-bit word, and each shuffle stage
// moves a 64-bit word as two shuffles. Design:
//   * Network branch (L <= 4,096): the row's words live in registers,
//     P = 16 consecutive words per lane (P = L / 32 for L < 512), W =
//     L / 512 warps per row. A stride below P is a compare-exchange
//     between two registers of one thread; a stride below one warp's span
//     (32 P) is __shfl_xor_sync between lanes, one shuffle per word;
//     only strides of 512 and more (rows of 1,024-4,096 slots) go through
//     shared memory, one store / load of the row around each merge's long
//     strides. Rows up to 512 slots are one warp each, eight to a block,
//     with no block barrier at all.
//   * Loads give lane l of warp w slot w * 32P + 32p + l in register p
//     (coalesced; the input order of a sort is free); pad words are made
//     in registers, never loaded. The sorted row leaves through the warp's
//     shared memory (padded one word per 128 bytes, so the strided writes
//     do not conflict) and is stored coalesced, slots >= C never written.
//   * Indexing is per row (row * C + slot) from the block and lane ids:
//     no division in the load or store loops.
//   * Global branch (L > 4,096): rows too wide for one block. A tile
//     kernel sorts every 4,096-word chunk of a row in alternating
//     directions into a 64-bit scratch buffer; then for each merge size
//     k > 4,096 the exchanges of stride j >= 4,096 run as one global-memory
//     pass each, and those below run in shared memory chunk by chunk; the
//     last merge writes the outputs. A second code path for a size the
//     first cannot hold, not a fallback.

#include "vt_common.cuh"

namespace {

constexpr int64_t kTileWords = 4096;  // network / global branch limit
constexpr int kTileThreads = 512;     // global branch tile kernel
constexpr uint64_t kPad64 = ~0ull;

__device__ __forceinline__ uint64_t pack(int32_t k, int32_t v) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(k) ^ 0x80000000u)
          << 32) |
         (static_cast<uint32_t>(v) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t unpack_key(uint64_t w) {
  return static_cast<int32_t>(static_cast<uint32_t>(w >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t unpack_val(uint64_t w) {
  return static_cast<int32_t>(static_cast<uint32_t>(w) ^ 0x80000000u);
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
  key_out[o] = unpack_key(w);
  val_out[o] = unpack_val(w);
}

// a, b := (min, max) when asc, else (max, min): one compare, two selects
template <typename Word>
__device__ __forceinline__ void order(Word& a, Word& b, bool asc) {
  const bool swap = (b < a) == asc;
  const Word first = swap ? b : a;
  b = swap ? a : b;
  a = first;
}

// Shared-memory index of in-row slot i: one pad word per 128 bytes, so a
// warp's accesses at a stride of P words fall in distinct banks.
template <typename Word>
__device__ __forceinline__ int padded(int i) {
  return i + (i >> (sizeof(Word) == 4 ? 5 : 4));
}

template <typename Word>
__host__ __device__ constexpr int padded_len(int L) {
  return L + L / (sizeof(Word) == 4 ? 32 : 16);
}

// One row of L = 32 * P * W words: W warps, P consecutive words a lane
// (slot index base + p, base = (warp * 32 + lane) * P). Rows with W == 1
// are eight to a block, a warp each; wider rows are one to a block.
template <typename Word, int P, int W>
__global__ void __launch_bounds__(W == 1 ? 256 : 32 * W)
sort_rows_net(const int32_t* __restrict__ key, const int32_t* __restrict__ val,
              int64_t R, int C, int32_t* __restrict__ key_out,
              int32_t* __restrict__ val_out) {
  constexpr int L = 32 * P * W;
  constexpr int kSpan = 32 * P;  // one warp's words
  constexpr Word kPadWord = static_cast<Word>(~0ull);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = W == 1 ? 0 : warp;  // warp within the row
  const int64_t row =
      W == 1 ? static_cast<int64_t>(blockIdx.x) * 8 + warp : blockIdx.x;
  if (row >= R) return;  // W == 1 only: no block barrier follows
  Word* s = reinterpret_cast<Word*>(smem_raw) +
            (W == 1 ? warp * padded_len<Word>(L) : 0);
  const int64_t g = row * C;
  const int base = (wr * 32 + lane) * P;

  Word x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = wr * kSpan + p * 32 + lane;
    x[p] = kPadWord;
    if (e < C) load_word(x[p], key, val, g + e);
  }

#pragma unroll
  for (int k = 2; k <= L; k <<= 1) {
    if (k > kSpan) {
      // strides of one warp's span and more, in shared memory
#pragma unroll
      for (int p = 0; p < P; ++p) s[padded<Word>(base + p)] = x[p];
      __syncthreads();
      for (int j = k >> 1; j >= kSpan; j >>= 1) {
        for (int t = threadIdx.x; t < L / 2; t += 32 * W) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          Word a = s[padded<Word>(i)], b = s[padded<Word>(i + j)];
          order(a, b, (i & k) == 0);
          s[padded<Word>(i)] = a;
          s[padded<Word>(i + j)] = b;
        }
        __syncthreads();
      }
#pragma unroll
      for (int p = 0; p < P; ++p) x[p] = s[padded<Word>(base + p)];
    }
#pragma unroll
    for (int j = (k >> 1) < (kSpan >> 1) ? (k >> 1) : (kSpan >> 1); j > 0;
         j >>= 1) {
      if (j >= P) {
        // partner lane ^ (j / P), same register; k > j >= P, so the
        // direction bit lies in base
        const bool keep_min = ((lane & (j / P)) == 0) == ((base & k) == 0);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const Word y = __shfl_xor_sync(0xffffffffu, x[p], j / P);
          if ((x[p] < y) != keep_min) x[p] = y;
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (p & j) continue;
          const bool asc = k < P ? (p & k) == 0 : (base & k) == 0;
          order(x[p], x[p | j], asc);
        }
      }
    }
  }

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
cudaError_t launch_net(const int32_t* k, const int32_t* v, int64_t R,
                       int64_t C, int32_t* ko, int32_t* vo, cudaStream_t s) {
  constexpr int rows_per_block = W == 1 ? 8 : 1;
  const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem =
      rows_per_block * padded_len<Word>(32 * P * W) * sizeof(Word);
  sort_rows_net<Word, P, W>
      <<<static_cast<unsigned>(blocks), 32 * W * rows_per_block, smem, s>>>(
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
    default: return cudaErrorInvalidValue;
  }
}

// Compare-exchange of words i < i + j of the global branch; ascending
// when bit k of the in-row lane of i is 0 (bitonic merge of size k).
__device__ __forceinline__ void exchange(uint64_t* a, uint64_t* b,
                                         int64_t lane, int64_t k) {
  const uint64_t x = *a, y = *b;
  const bool asc = (lane & k) == 0;
  if ((x > y) == asc) {
    *a = y;
    *b = x;
  }
}

// Global branch: one chunk of kTileWords words, starting at flat index
// g0 = blockIdx.x * kTileWords of the padded [R, L] array (L a multiple
// of kTileWords). Source: the int32 inputs (src == nullptr) or the
// scratch words; destination: the scratch words (dst != nullptr) or the
// int32 outputs. Runs merges k = kfrom .. kto, the first from stride
// jfrom.
__global__ void __launch_bounds__(kTileThreads)
sort_tile(const int32_t* __restrict__ key, const int32_t* __restrict__ val,
          const uint64_t* src, uint64_t* dst,  // may be one buffer
          int32_t* __restrict__ key_out, int32_t* __restrict__ val_out,
          int64_t C, int lg_l, int64_t kfrom, int64_t kto, int jfrom) {
  extern __shared__ uint64_t s[];
  constexpr int E = static_cast<int>(kTileWords);
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * E;
  const int64_t r = g0 >> lg_l;
  const int64_t c0 = g0 - (r << lg_l);
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    uint64_t w = kPad64;
    if (src != nullptr)
      w = src[g0 + t];
    else if (c0 + t < C)
      w = pack(key[r * C + c0 + t], val ? val[r * C + c0 + t] : 0);
    s[t] = w;
  }
  __syncthreads();
  for (int64_t k = kfrom; k <= kto; k <<= 1) {
    for (int j = (k == kfrom ? jfrom : static_cast<int>(k >> 1)); j > 0;
         j >>= 1) {
      for (int t = threadIdx.x; t < E / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        exchange(&s[i], &s[i + j], c0 + i, k);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    if (dst != nullptr) {
      dst[g0 + t] = s[t];
    } else if (c0 + t < C) {
      key_out[r * C + c0 + t] = unpack_key(s[t]);
      if (val_out) val_out[r * C + c0 + t] = unpack_val(s[t]);
    }
  }
}

// One stage (k, j) of the network over the whole scratch array, for
// strides too long for a tile.
__global__ void __launch_bounds__(256)
sort_global_stage(uint64_t* __restrict__ w, int64_t pairs, int64_t L,
                  int64_t k, int64_t j) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < pairs; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    exchange(&w[i], &w[i + j], i & (L - 1), k);
  }
}

int lg2_at_least(int64_t c) {
  int lg = 0;
  while ((int64_t{1} << lg) < c) ++lg;
  return lg;
}

}  // namespace

// 1 when rows of padded width L sort in the register network, 0 for the
// global branch (which needs an int64 scratch buffer of R * L words).
VT_EXPORT int vt_sort_rows_uses_network(int64_t L) { return L <= kTileWords; }

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
  if (scratch == nullptr) return cudaErrorInvalidValue;
  auto* w = static_cast<uint64_t*>(scratch);
  const int64_t tiles = R * L / kTileWords;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = kTileWords * sizeof(uint64_t);
  sort_tile<<<static_cast<unsigned>(tiles), kTileThreads, smem, s>>>(
      k, v, nullptr, w, nullptr, nullptr, C, lg_l, 2, kTileWords, 1);
  cudaError_t err = cudaGetLastError();
  const int64_t pairs = R * L / 2;
  const int64_t blocks64 = (pairs + 255) / 256;
  const unsigned blocks =
      static_cast<unsigned>(blocks64 < (1 << 20) ? blocks64 : (1 << 20));
  for (int64_t m = 2 * kTileWords; m <= L && err == cudaSuccess; m <<= 1) {
    for (int64_t j = m >> 1; j >= kTileWords; j >>= 1)
      sort_global_stage<<<blocks, 256, 0, s>>>(w, pairs, L, m, j);
    const bool last = m == L;
    sort_tile<<<static_cast<unsigned>(tiles), kTileThreads, smem, s>>>(
        nullptr, nullptr, w, last ? nullptr : w, last ? ko : nullptr,
        last ? vo : nullptr, C, lg_l, m, m,
        static_cast<int>(kTileWords / 2));
    err = cudaGetLastError();
  }
  return err;
}
