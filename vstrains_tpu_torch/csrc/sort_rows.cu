// Row-wise ascending sort of int32 [R, C] by (key, val).
//
// Replaces vstrains_tpu/ops/pallas_sort.py::sort_rows_pallas (kernel
// _rowsort_kernel, the roll-based bitonic network) and the jax.lax.sort
// row sorts of the sparse PE tail (ops/pe_infer.py::_row_run_stats and
// _sort_compact_runs); key-only on the transpose it also stands for the
// column sorter prototype tools/colsort_proto.py::sort_cols_pallas.
//
// Each slot becomes one 64-bit word (key ^ 0x80000000) << 32 |
// (val ^ 0x80000000), so an unsigned compare of two words is the signed
// (key, val) order, and the compare-exchange moves key and value together.
// A row pads to L = the next power of two >= C with all-ones words (key =
// val = INT32_MAX), which sort last and are not written back. Key-only
// calls (val == nullptr) pack val as 0, so the key alone orders the row.
//
// What bounds it on the card: shared-memory traffic. A bitonic network
// over L words runs log2(L) * (log2(L) + 1) / 2 compare-exchange stages;
// device memory sees every word once in and once out. At the sparse tail's
// shape (R = 32,768 rows, L = 512) that is 45 stages over 8.4M words per
// launch. Design, not the TPU's: the TPU kernel expresses every exchange
// with two lane rolls and selects because Mosaic lacks the reshapes; on
// the card each thread indexes its pair directly in shared memory.
//   * Shared branch (L <= kTileWords): one block holds one tile of whole
//     rows (several short rows per block, E = max(L, kMinTile) words) and
//     runs the full network between barriers, reading the inputs and
//     writing the outputs once, coalesced.
//   * Global branch (L > kTileWords): rows too wide for one block. The
//     same tile kernel first sorts every kTileWords chunk of a row in
//     alternating directions into a 64-bit scratch buffer; then for each
//     merge size k > kTileWords the exchanges of stride j >= kTileWords run
//     as one global-memory pass each, and those of stride j < kTileWords
//     run in shared memory chunk by chunk; the last merge writes the
//     outputs. The same shape as stats_accum's shared and global branches:
//     a second code path for a size the first cannot hold, not a fallback.

#include "vt_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int64_t kTileWords = 4096;  // 32 KB of words: the shared limit
constexpr int64_t kMinTile = 2048;    // short rows share a block
constexpr uint64_t kPad = ~0ull;

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

// Compare-exchange of words i < i + j; the pair sorts ascending when bit
// k of the in-row lane of i is 0 (bitonic merge of size k).
__device__ __forceinline__ void exchange(uint64_t* a, uint64_t* b,
                                         int64_t lane, int64_t k) {
  const uint64_t x = *a, y = *b;
  const bool asc = (lane & k) == 0;
  if ((x > y) == asc) {
    *a = y;
    *b = x;
  }
}

// One tile of E words, starting at flat index g0 = blockIdx.x * E of the
// padded [R, L] array. Source: the int32 inputs (src == nullptr) or the
// scratch words; destination: the scratch words (dst != nullptr) or the
// int32 outputs. Runs merges k = kfrom .. kto, the first from stride jfrom.
__global__ void __launch_bounds__(kThreads)
sort_tile(const int32_t* __restrict__ key, const int32_t* __restrict__ val,
          const uint64_t* src, uint64_t* dst,  // may be one buffer
          int32_t* __restrict__ key_out, int32_t* __restrict__ val_out,
          int64_t R, int64_t C, int64_t L, int E, int64_t kfrom,
          int64_t kto, int jfrom) {
  extern __shared__ uint64_t s[];
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * E;
  const int64_t total = R * L;
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    const int64_t g = g0 + t;
    uint64_t w = kPad;
    if (g < total) {
      if (src != nullptr) {
        w = src[g];
      } else {
        const int64_t r = g / L, c = g - r * L;
        if (c < C) w = pack(key[r * C + c], val ? val[r * C + c] : 0);
      }
    }
    s[t] = w;
  }
  __syncthreads();
  const int half = E / 2;
  for (int64_t k = kfrom; k <= kto; k <<= 1) {
    for (int j = (k == kfrom ? jfrom : static_cast<int>(k >> 1)); j > 0;
         j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        exchange(&s[i], &s[i + j], (g0 + i) & (L - 1), k);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    const int64_t g = g0 + t;
    if (g >= total) break;
    if (dst != nullptr) {
      dst[g] = s[t];
    } else {
      const int64_t r = g / L, c = g - r * L;
      if (c < C) {
        key_out[r * C + c] = unpack_key(s[t]);
        if (val_out) val_out[r * C + c] = unpack_val(s[t]);
      }
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

int64_t pow2_at_least(int64_t c) {
  int64_t L = 1;
  while (L < c) L <<= 1;
  return L;
}

}  // namespace

// 1 when rows of padded width L sort in the shared branch, 0 for the
// global branch (which needs an int64 scratch buffer of R * L words).
VT_EXPORT int vt_sort_rows_uses_shared(int64_t L) { return L <= kTileWords; }

VT_EXPORT int vt_sort_rows(const void* key, const void* val, int64_t R,
                           int64_t C, void* key_out, void* val_out,
                           void* scratch, void* stream) {
  if (R <= 0 || C <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(key);
  const auto* v = static_cast<const int32_t*>(val);
  auto* ko = static_cast<int32_t*>(key_out);
  auto* vo = static_cast<int32_t*>(val_out);
  const int64_t L = pow2_at_least(C);
  if (vt_sort_rows_uses_shared(L)) {
    const int64_t E = L > kMinTile ? L : kMinTile;
    const int64_t tiles = (R * L + E - 1) / E;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    sort_tile<<<static_cast<unsigned>(tiles), kThreads, E * sizeof(uint64_t),
                s>>>(k, v, nullptr, nullptr, ko, vo, R, C, L,
                     static_cast<int>(E), 2, L, 1);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  auto* w = static_cast<uint64_t*>(scratch);
  const int64_t tiles = R * L / kTileWords;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = kTileWords * sizeof(uint64_t);
  const int E = static_cast<int>(kTileWords);
  sort_tile<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      k, v, nullptr, w, nullptr, nullptr, R, C, L, E, 2, kTileWords, 1);
  cudaError_t err = cudaGetLastError();
  const int64_t pairs = R * L / 2;
  const int64_t blocks64 = (pairs + 255) / 256;
  const unsigned blocks =
      static_cast<unsigned>(blocks64 < (1 << 20) ? blocks64 : (1 << 20));
  for (int64_t m = 2 * kTileWords; m <= L && err == cudaSuccess; m <<= 1) {
    for (int64_t j = m >> 1; j >= kTileWords; j >>= 1)
      sort_global_stage<<<blocks, 256, 0, s>>>(w, pairs, L, m, j);
    const bool last = m == L;
    sort_tile<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
        nullptr, nullptr, w, last ? nullptr : w, last ? ko : nullptr,
        last ? vo : nullptr, R, C, L, E, m, m,
        static_cast<int>(kTileWords / 2));
    err = cudaGetLastError();
  }
  return err;
}
