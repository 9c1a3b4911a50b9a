// Link counts of one batch, added into the run's int64 accumulators.
//
// Replaces vstrains_tpu/ops/pallas_kernels.py::pair_matmuls_pallas (kernel
// _pair_kernel), and its XLA counterpart ops/pe_infer.py::_pair_matmuls.
//
// f, r: uint8 0/1 saturation masks [B, N] of the forward and reverse
// reads of B pairs. Adds, for every node pair (i, j):
//   acc_nm[i, j] += sum_b f[b, i] * r[b, j]
//   acc_sm[i, j] += sum_b f[b, i] * f[b, j] + r[b, i] * r[b, j]   (i <= j)
// acc_sm's lower triangle is never touched (the reference's triangular
// pair loop, PE_Inference.py:174-188).
//
// What bounds it on the card: as a dense product it is 3 * B * N^2
// multiply-adds (29 G at B = 16,384, N = 773) on inputs of only 2*B*N
// bytes. Design: the masks are 0/1, so 32 reads of a node pack into one
// 32-bit word and one AND + popcount does 32 multiply-adds; the bound is
// then the SM's popcount rate. Two launches:
//   1. pack_words: each thread owns one node column and 32 reads, loads
//      the 32 bytes (every warp load is 32 consecutive bytes of one row)
//      and writes one word of the word-major planes fw, rw [ceil(B/32), N];
//   2. pair_counts_kernel: each block owns one 64 x 64 tile of the N x N
//      output and loops over all the batch's words inside the block (the
//      TPU kernel's sequential grid over B-blocks becomes this loop). Per
//      step it stages 32 words of its row and column tiles in shared
//      memory (coalesced: 64 consecutive words per load row), and each
//      thread adds popcounts into its 4 x 4 outputs in int32 registers.
// The sums are added once into the int64 accumulators at the end, so no
// two blocks write one cell and no atomics are needed. Tiles below the
// diagonal compute only node_mat; the diagonal tile masks its lower half
// out of short_mat. Per-batch int32 sums are exact: a cell counts at most
// 2B < 2^31. No matrix library and no tensor cores are used here.

#include "vt_common.cuh"

namespace {

constexpr int kPackThreads = 256;  // node columns per pack block
constexpr int kTile = 64;          // output tile edge
constexpr int kThreads = 256;
constexpr int kStep = 32;          // words (32 reads each) staged per step
constexpr int kMicro = 4;          // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kPackThreads)
pack_words(const uint8_t* __restrict__ f, const uint8_t* __restrict__ r,
           int64_t B, int N, uint32_t* __restrict__ fw,
           uint32_t* __restrict__ rw) {
  const int col = blockIdx.x * kPackThreads + threadIdx.x;
  const int64_t w = blockIdx.y;
  if (col >= N) return;
  uint32_t fbits = 0, rbits = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int64_t b = w * 32 + k;
    if (b < B) {
      fbits |= static_cast<uint32_t>(f[b * N + col] != 0) << k;
      rbits |= static_cast<uint32_t>(r[b * N + col] != 0) << k;
    }
  }
  fw[w * N + col] = fbits;
  rw[w * N + col] = rbits;
}

__global__ void __launch_bounds__(kThreads)
pair_counts_kernel(const uint32_t* __restrict__ fw,
                   const uint32_t* __restrict__ rw, int64_t W, int N,
                   int64_t* __restrict__ acc_nm,
                   int64_t* __restrict__ acc_sm) {
  // staged words: 0 = f of the row tile (i), 1 = r of i, 2 = f of the
  // column tile (j), 3 = r of j
  __shared__ __align__(16) uint32_t s_w[4][kStep][kTile];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const bool upper = blockIdx.y <= blockIdx.x;
  const int ty = threadIdx.x / (kTile / kMicro);
  const int tx = threadIdx.x % (kTile / kMicro);
  constexpr int kLoads = 4 * kStep * kTile / kThreads;

  int32_t nm[kMicro][kMicro] = {};
  int32_t sm[kMicro][kMicro] = {};

  for (int64_t w0 = 0; w0 < W; w0 += kStep) {
    uint32_t v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = k * kThreads + threadIdx.x;
      const int a = idx / (kStep * kTile);
      const int w = (idx / kTile) % kStep;
      const int col = (a < 2 ? i0 : j0) + idx % kTile;
      const uint32_t* src = (a & 1) ? rw : fw;
      v[k] = (w0 + w < W && col < N) ? src[(w0 + w) * N + col] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = k * kThreads + threadIdx.x;
      s_w[idx / (kStep * kTile)][(idx / kTile) % kStep][idx % kTile] = v[k];
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < kStep; ++w) {
      const uint4 fi = *reinterpret_cast<const uint4*>(&s_w[0][w][ty * kMicro]);
      const uint4 ri = *reinterpret_cast<const uint4*>(&s_w[1][w][ty * kMicro]);
      const uint4 fj = *reinterpret_cast<const uint4*>(&s_w[2][w][tx * kMicro]);
      const uint4 rj = *reinterpret_cast<const uint4*>(&s_w[3][w][tx * kMicro]);
      const uint32_t fia[kMicro] = {fi.x, fi.y, fi.z, fi.w};
      const uint32_t ria[kMicro] = {ri.x, ri.y, ri.z, ri.w};
      const uint32_t fja[kMicro] = {fj.x, fj.y, fj.z, fj.w};
      const uint32_t rja[kMicro] = {rj.x, rj.y, rj.z, rj.w};
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          nm[a][c] += __popc(fia[a] & rja[c]);
          if (upper)
            sm[a][c] += __popc(fia[a] & fja[c]) + __popc(ria[a] & rja[c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty * kMicro + a;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = j0 + tx * kMicro + c;
      if (j >= N) continue;
      const int64_t o = static_cast<int64_t>(i) * N + j;
      acc_nm[o] += nm[a][c];
      if (upper && i <= j) acc_sm[o] += sm[a][c];
    }
  }
}

}  // namespace

// f, r: uint8 [B, N] (row stride N); words: uint32 scratch of
// 2 * ceil(B/32) * N entries; acc_nm, acc_sm: int64 [N, N].
VT_EXPORT int vt_pair_counts(const void* f, const void* r, int64_t B,
                             int64_t N, void* words, void* acc_nm,
                             void* acc_sm, void* stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t W = (B + 31) / 32;
  if (W > 65535) return cudaErrorInvalidConfiguration;  // grid.y limit
  auto* fw = static_cast<uint32_t*>(words);
  auto* rw = fw + W * N;
  pack_words<<<dim3(static_cast<unsigned>((N + kPackThreads - 1)
                                          / kPackThreads),
                    static_cast<unsigned>(W)),
               kPackThreads, 0, s>>>(static_cast<const uint8_t*>(f),
                                     static_cast<const uint8_t*>(r), B,
                                     static_cast<int>(N), fw, rw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((N + kTile - 1) / kTile);
  pair_counts_kernel<<<dim3(tiles, tiles), kThreads, 0, s>>>(
      fw, rw, W, static_cast<int>(N), static_cast<int64_t*>(acc_nm),
      static_cast<int64_t*>(acc_sm));
  return cudaGetLastError();
}
