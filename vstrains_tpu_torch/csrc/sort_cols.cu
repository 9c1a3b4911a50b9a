// Column-wise ascending sort of int32 [L, W] (key only): each of the W
// columns of L rows sorted on its own.
//
// Replaces tools/colsort_proto.py::sort_cols_pallas, the TPU prototype of
// a bitonic sort along the sublane axis (each compare-exchange elementwise
// between row slices of an (L, blk) tile in VMEM).
//
// What bounds it on the card: device memory sees every word once in and
// once out, 33.6 MB at 2,048 x 2,048, i.e. 0.010 ms at 3.35 TB/s (H100
// SXM published peak at 700 W); the bitonic network's log2(Lp) (log2(Lp)
// + 1) / 2 stages over each column padded to Lp = the next power of two
// (66 at 2,048) are the work in between. Design: no global transposes.
//   * A block owns NC = 32 / Wc adjacent columns, where one column of Lp
//     words is held by Wc warps of P words a lane (sort_net.cuh: P = 16,
//     Wc = Lp / 512 from 1,024 rows; one warp of Lp / 32 words below), so
//     every block has 1,024 threads. It reads the L x NC tile row by row:
//     consecutive threads on consecutive columns, so a warp's load covers
//     whole row segments of 4 NC bytes (32 B at Lp = 2,048, 128 B up to
//     512 rows), once.
//   * The tile lands in shared memory column-major, column c at c * CS,
//     row l at the network's padded index of l; CS = padded_len(Lp) + the
//     words that make CS = Wc (mod 32), so the 32 / NC rows x NC columns of
//     a warp's access fall in 32 distinct banks.
//   * Each column group reads its column in the network's normal layout
//     (pad words past L made in registers), sorts it with the register and
//     shuffle network, whose long strides use the column's own region of
//     the tile, and writes it back there; the block then stores the tile
//     row by row as it was read. Columns past W (the last block) sort pad
//     words and store nothing.
//   * Shared memory: NC * CS words, 66-68 KB at every Lp >= 512 (opted
//     into before the launch; a refused opt-in is the launch's error),
//     so two blocks of 1,024 threads fit an SM.

#include "sort_net.cuh"

namespace {

using vt::sortnet::net_sort;
using vt::sortnet::padded;
using vt::sortnet::padded_len;

constexpr int kThreads = 1024;

// the column stride of the shared tile: room for a padded column of Lp
// words, congruent with the warps a column (Wc) modulo the 32 banks
__host__ __device__ constexpr int col_stride(int Lp, int Wc) {
  return padded_len<uint32_t>(Lp) +
         ((Wc - padded_len<uint32_t>(Lp) % 32) % 32 + 32) % 32;
}

template <int P, int Wc>
__global__ void __launch_bounds__(kThreads)
sort_cols_net(const int32_t* __restrict__ x, int rows, int64_t cols,
              int32_t* __restrict__ out) {
  constexpr int Lp = 32 * P * Wc;
  constexpr int NC = 32 / Wc;  // columns a block
  constexpr int kLgNC = vt::sortnet::lg2(NC);
  constexpr int CS = col_stride(Lp, Wc);
  extern __shared__ __align__(16) uint32_t s[];
  const int tid = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * NC;

  // tile in: element i = (row i / NC, column i % NC), coalesced
  for (int i = tid; i < rows * NC; i += kThreads) {
    const int l = i >> kLgNC;
    const int c = i & (NC - 1);
    if (c0 + c < cols)
      s[c * CS + padded<uint32_t>(l)] =
          static_cast<uint32_t>(x[l * cols + c0 + c]) ^ 0x80000000u;
  }
  __syncthreads();

  const int col = tid / (32 * Wc);  // this thread's column of the tile
  const int ct = tid % (32 * Wc);   // its thread within the column
  uint32_t* sc = s + col * CS;
  const bool live = c0 + col < cols;
  uint32_t v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = ct * P + p;
    v[p] = live && i < rows ? sc[padded<uint32_t>(i)] : ~0u;
  }
  net_sort<uint32_t, P, Wc, 2>(v, sc, ct, false);
  // back into the tile: a thread rewrites only its own slots, which it
  // alone has read since the last barrier
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (ct * P + p < rows) sc[padded<uint32_t>(ct * P + p)] = v[p];
  __syncthreads();

  for (int i = tid; i < rows * NC; i += kThreads) {
    const int l = i >> kLgNC;
    const int c = i & (NC - 1);
    if (c0 + c < cols)
      out[l * cols + c0 + c] =
          static_cast<int32_t>(s[c * CS + padded<uint32_t>(l)] ^ 0x80000000u);
  }
}

template <int P, int Wc>
cudaError_t launch_cols(const int32_t* x, int64_t rows, int64_t cols,
                        int32_t* out, cudaStream_t s) {
  constexpr int NC = 32 / Wc;
  const int64_t blocks = (cols + NC - 1) / NC;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(NC) * col_stride(32 * P * Wc, Wc) * 4;
  const cudaError_t err = vt::allow_smem(sort_cols_net<P, Wc>, smem);
  if (err != cudaSuccess) return err;
  sort_cols_net<P, Wc><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      x, static_cast<int>(rows), cols, out);
  return cudaGetLastError();
}

}  // namespace

VT_EXPORT int vt_sort_cols(const void* x, int64_t rows, int64_t cols,
                           void* out, void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  int64_t Lp = 32;
  while (Lp < rows) Lp <<= 1;
  const auto* in = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (Lp) {
    case 32: return launch_cols<1, 1>(in, rows, cols, o, s);
    case 64: return launch_cols<2, 1>(in, rows, cols, o, s);
    case 128: return launch_cols<4, 1>(in, rows, cols, o, s);
    case 256: return launch_cols<8, 1>(in, rows, cols, o, s);
    case 512: return launch_cols<16, 1>(in, rows, cols, o, s);
    case 1024: return launch_cols<16, 2>(in, rows, cols, o, s);
    case 2048: return launch_cols<16, 4>(in, rows, cols, o, s);
    case 4096: return launch_cols<16, 8>(in, rows, cols, o, s);
    case 8192: return launch_cols<16, 16>(in, rows, cols, o, s);
    case 16384: return launch_cols<16, 32>(in, rows, cols, o, s);
    default: return cudaErrorInvalidValue;
  }
}
