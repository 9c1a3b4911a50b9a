// Dual 32-bit window hashes of a stacked read batch, fused with the
// unpacking of the compact wire format.
//
// Replaces vstrains_tpu/ops/pallas_kernels.py::window_hashes_pallas
// (kernel _hash_kernel), and the XLA path the JAX engine runs by default,
// ops/pe_infer.py::_unpack_wire + _device_window_hashes.
//
// For every row r of the stacked end-batch (rows 0..B-1 are the forward
// reads of the B pairs, rows B..2B-1 the reverse reads) and every window
// j < K = T - L + 1:
//   h = sum_i (code[j+i] + 1) * M^(L-1-i)  mod 2^32,  M = 0x9E3779B1 / 0x85EBCA77
//   q1 = h1 ^ 0x80000000 (the sort order of the signed table keys), h2 raw,
//   valid = the window lies inside the read and holds no code >= 4.
// A code >= 4 counts as 0 in the sum, as in the JAX package.
//
// Two entries: the wire feed (uint8 [B, 2*ceil(T/4) + 4]: 2-bit forward
// bases | 2-bit reverse bases | u16 forward length | u16 reverse length)
// and the byte feed (uint8 codes [2B, T] + int32 lengths), which carries
// in-read non-ACGT codes and 255 padding past the read's end.
//
// What bounds it on the card: the bytes of its three outputs. At the HIV
// shape (2B = 32,768 rows, T = 256, L = 57, K = 200) it writes
// 9 bytes x 6.55M windows = 59 MB and reads 2.1 MB of wire; the 2 x 57
// multiply-adds per window are ~0.75 G integer ops, well under the card's
// integer rate at that byte count. Design: one block per row; the block
// unpacks the row's codes once into shared memory, together with the two
// power tables, and each thread evaluates whole windows straight from
// shared memory (the L-term definition: no prefix sums, no modular
// inverses), writing q1/h2/valid coalesced along the row with no lane
// padding.

#include "vt_common.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kWire>
__global__ void __launch_bounds__(kThreads)
window_hashes_kernel(const uint8_t* __restrict__ src,
                     const int32_t* __restrict__ lens,
                     int64_t B, int64_t W, int64_t T, int L,
                     const uint32_t* __restrict__ pows,
                     int32_t* __restrict__ q1, int32_t* __restrict__ h2,
                     uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_p1 = smem;
  uint32_t* s_p2 = smem + L;
  uint8_t* s_code = reinterpret_cast<uint8_t*>(smem + 2 * L);
  const int64_t row = blockIdx.x;
  const int64_t K = T - L + 1;

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_p1[i] = pows[i];
    s_p2[i] = pows[L + i];
  }
  int len;
  if (kWire) {
    const int half = row < B ? 0 : 1;
    const uint8_t* wrow = src + (row - half * B) * W;
    const uint8_t* packed = wrow + half * ((T + 3) / 4);
    for (int64_t t = threadIdx.x; t < T; t += blockDim.x)
      s_code[t] = (packed[t >> 2] >> ((t & 3) * 2)) & 3;
    len = int(wrow[W - 4 + 2 * half]) | (int(wrow[W - 3 + 2 * half]) << 8);
  } else {
    const uint8_t* crow = src + row * T;
    for (int64_t t = threadIdx.x; t < T; t += blockDim.x)
      s_code[t] = crow[t];
    len = lens[row];
  }
  __syncthreads();

  for (int64_t j = threadIdx.x; j < K; j += blockDim.x) {
    uint32_t a1 = 0, a2 = 0;
    bool bad = false;
    for (int i = 0; i < L; ++i) {
      const uint32_t c = s_code[j + i];
      bad |= c >= 4;
      const uint32_t v = (c < 4 ? c : 0) + 1;
      a1 += v * s_p1[i];
      a2 += v * s_p2[i];
    }
    const int64_t o = row * K + j;
    q1[o] = static_cast<int32_t>(a1 ^ 0x80000000u);
    h2[o] = static_cast<int32_t>(a2);
    valid[o] = (!bad && j + L <= len) ? 1 : 0;
  }
}

template <bool kWire>
int launch(const void* src, const void* lens, int64_t B, int64_t W,
           int64_t T, int64_t L, int64_t rows, const void* pows, void* q1,
           void* h2, void* valid, void* stream) {
  if (rows <= 0 || T < L || L <= 0) return cudaSuccess;
  const size_t smem = 2 * L * sizeof(uint32_t) + T;
  cudaError_t err = vt::allow_smem(window_hashes_kernel<kWire>, smem);
  if (err != cudaSuccess) return err;
  window_hashes_kernel<kWire>
      <<<static_cast<unsigned>(rows), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(src),
          static_cast<const int32_t*>(lens), B, W, T, static_cast<int>(L),
          static_cast<const uint32_t*>(pows), static_cast<int32_t*>(q1),
          static_cast<int32_t*>(h2), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // namespace

// wire: uint8 [B, W], W = 2*ceil(T/4) + 4 -> q1, h2 int32 [2B, K], valid
// uint8 [2B, K]. pows: uint32 [2, L], row d holds M_d^(L-1-i).
VT_EXPORT int vt_window_hashes_wire(const void* wire, int64_t B, int64_t W,
                                    int64_t T, int64_t L, const void* pows,
                                    void* q1, void* h2, void* valid,
                                    void* stream) {
  return launch<true>(wire, nullptr, B, W, T, L, 2 * B, pows, q1, h2, valid,
                      stream);
}

// codes: uint8 [R, T], lens: int32 [R] -> q1, h2 int32 [R, K], valid
// uint8 [R, K].
VT_EXPORT int vt_window_hashes_bytes(const void* codes, const void* lens,
                                     int64_t R, int64_t T, int64_t L,
                                     const void* pows, void* q1, void* h2,
                                     void* valid, void* stream) {
  return launch<false>(codes, lens, 0, T, T, L, R, pows, q1, h2, valid,
                       stream);
}
