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
//   h = sum_i v[j+i] * M^(L-1-i)  mod 2^32,  v = (c < 4 ? c : 0) + 1,
//   M = 0x9E3779B1 / 0x85EBCA77,
//   q1 = h1 ^ 0x80000000 (the sort order of the signed table keys), h2 raw,
//   valid = the window lies inside the read and holds no code >= 4.
// Every window is hashed, valid or not, as in the JAX package.
//
// Two entries: the wire feed (uint8 [B, 2*ceil(T/4) + 4]: 2-bit forward
// bases | 2-bit reverse bases | u16 forward length | u16 reverse length)
// and the byte feed (uint8 codes [2B, T] + int32 lengths), which carries
// in-read non-ACGT codes and 255 padding past the read's end.
//
// What bounds it on the card: the bytes of its three outputs. At the HIV
// dense shape (2B = 32,768 rows, T = 256, L = 56, K = 201) it writes
// 9 bytes x 6.59M windows = 59.3 MB and reads 2.2 MB of wire: 0.018 ms at
// 3.35 TB/s (H100 SXM published peak at 700 W). The first design evaluated
// every window from the L-term definition with three shared-memory loads
// a term, and the rate of shared-memory loads bound it at ~10% of that.
// Design:
//   * Each warp works alone (no block barrier) on 32 / G consecutive rows,
//     G = 8 lanes a row. It unpacks its rows into shared memory, one byte
//     per code: v, with bit 7 set for a code >= 4 (the byte feed's bad
//     codes), with up to kBatch loads of each lane in flight.
//   * Lane g of a row owns the contiguous run of windows
//     [g * run, (g + 1) * run), run = ceil(K / G). It computes its first
//     window by Horner's rule, h = h * M + v over L codes, and rolls to
//     each next one with h = (h - v_out * M^(L-1)) * M + v_in, in uint32
//     (wrap-around is exact mod 2^32), with a rolling count of bad codes.
//     q1 is carried as h1 + 2^31, which obeys the same two steps (M is
//     odd, so 2^31 M = 2^31 mod 2^32). No power table: the wrapper passes
//     M and M^(L-1) per hash. Codes are read four at a time as words (a
//     funnel shift of two aligned words). A row's first windows cost
//     G L steps and its rolls K, so a small G does less work and a large
//     G keeps more warps resident (each row stages 9 K bytes).
//   * Outputs are staged in shared memory as the warp's flat range
//     [row0 * K, (row0 + 32 / G) * K), which is contiguous in the [R, K]
//     layout, and leave with 16-byte stores, the partial groups at the two
//     ends one element a lane (rows are not 16-byte aligned: K * 4 = 804
//     bytes at the HIV shape).
//   * A row too wide for four a warp (T >= 660 at L = 56) takes 32
//     lanes and is cut into chunks of kChunk windows, one warp a chunk,
//     which stages the chunk's windows and the codes they cover; so the
//     shared memory stays bounded at any T (reads of 2^16 bases and more
//     come through the byte feed).

#include "vt_common.cuh"

namespace {

constexpr int kLanes = 8;               // lanes a row that fits four a warp
constexpr int kWarps = 2;               // warps a block
constexpr int kChunk = 32 * 33;         // windows a warp takes of a wide row
constexpr int kBatch = 4;               // loads a lane keeps in flight
constexpr int64_t kSmem = 48 * 1024;    // a block's shared memory, aimed at
constexpr int64_t kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr uint32_t kBadBits = 0x80808080u;  // bit 7 of each code byte
constexpr uint32_t kBias = 0x80000000u;     // q1 = h1 + 2^31

__host__ __device__ inline int64_t round16(int64_t bytes) {
  return (bytes + 15) & ~int64_t(15);
}

// A warp's shared memory for `rows` rows of `chunk` windows each: q1 and
// h2 staging (rows * chunk words and room for a 3-word head offset), valid
// staging (rows * chunk bytes, 15-byte head room), then each row's code
// bytes (the chunk + L - 1 codes its windows cover, 16 bytes of room for
// the word reads past the last).
struct Layout {
  int64_t words, flags, stride;
  __host__ __device__ Layout(int rows, int64_t chunk, int64_t L)
      : words(round16(4 * (rows * chunk + 3))),
        flags(round16(rows * chunk + 15)), stride(round16(chunk + L + 15)) {}
  __host__ __device__ int64_t bytes(int rows) const {
    return 2 * words + flags + rows * stride;
  }
};

// How a launch splits the work: lanes a row (32 / lanes rows a warp),
// windows a lane, windows a warp takes of each of its rows and how many
// such chunks a row has, warps a block and its shared memory. Rows that
// fit four to a warp of a kWarps block within kSmem take kLanes lanes and
// are not cut; a wider row takes a warp alone, kChunk windows at a time.
struct Plan {
  int lanes, run, chunk;
  int64_t chunks;
  int warps;
  int64_t smem;
};

Plan plan(int64_t T, int64_t L) {
  const int64_t K = T - L + 1;
  Plan p{kLanes, 0, static_cast<int>(K), 1, kWarps, 0};
  if (Layout(32 / kLanes, K, L).bytes(32 / kLanes) > kSmem / kWarps) {
    p.lanes = 32;
    p.chunk = static_cast<int>(K < kChunk ? K : kChunk);
    p.chunks = (K + p.chunk - 1) / p.chunk;
  }
  // one row a warp: an odd run puts the 32 lanes' staging stores in 32
  // banks (an even one would share banks, 32 to one at run 32)
  p.run = (p.chunk + p.lanes - 1) / p.lanes;
  if (p.lanes == 32) p.run |= 1;
  const int rows = 32 / p.lanes;
  const int64_t per_warp = Layout(rows, p.chunk, L).bytes(rows);
  while (p.warps > 1 && p.warps * per_warp > kSmem) p.warps /= 2;
  p.smem = p.warps * per_warp;
  return p;
}

// Four code bytes at a time from byte position p of a row's codes, as one
// word (byte b = code p + b), each word loaded once.
struct CodeStream {
  const uint32_t* w;
  uint32_t lo, shift;
  __device__ CodeStream(const uint32_t* codes, int p)
      : w(codes + (p >> 2) + 1), lo(codes[p >> 2]), shift((p & 3) * 8) {}
  __device__ uint32_t next() {
    const uint32_t hi = *w++;
    const uint32_t x = __funnelshift_r(lo, hi, shift);
    lo = hi;
    return x;
  }
};

__device__ __forceinline__ uint32_t code_v(uint32_t x, int b) {
  return (x >> (8 * b)) & 7u;
}

// dst[0, n) = s[off, off + n), where dst - off is 16-byte aligned: one
// 16-byte store for each whole group, and the partial groups at the two
// ends (under 16 elements each) one element a lane, lanes 0-15 the head
// and 16-31 the tail.
template <typename T>
__device__ void store_range(T* dst, const T* s, int off, int n, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  T* base = dst - off;
  const int end = off + n;
  const int head = min(end, (off + kPer - 1) / kPer * kPer);
  const int tail = max(head, end / kPer * kPer);
  const int k = lane < 16 ? off + lane : tail + lane - 16;
  if (k < (lane < 16 ? head : end)) base[k] = s[k];
#pragma unroll 1
  for (int lo = head + lane * kPer; lo < tail; lo += 32 * kPer)
    *reinterpret_cast<uint4*>(base + lo) =
        *reinterpret_cast<const uint4*>(s + lo);
}

// Word i of the warp's staged codes: row i / sw of the warp, codes
// c0 + 4 (i % sw) .. + 3, as the feed gives them (wire: one packed byte;
// c0 is a multiple of 4).
template <bool kWire>
__device__ __forceinline__ uint32_t load_word(
    const uint8_t* __restrict__ src, int64_t row0, int64_t B, int64_t W,
    int T, int c0, int sw, float inv_sw, bool aligned, int i) {
  int r = __float2int_rz(__int2float_rn(i) * inv_sw);
  r += (r + 1) * sw <= i;
  r -= r * sw > i;
  const int t = i - r * sw + c0 / 4;
  const int64_t row = row0 + r;
  if (kWire) {
    const int T4 = (T + 3) / 4;
    const int64_t half = row < B ? 0 : 1;
    return t < T4 ? src[(row - half * B) * W + half * T4 + t] : 0u;
  }
  const uint8_t* c = src + row * T + 4 * t;
  if (aligned && 4 * t + 4 <= T) return *reinterpret_cast<const uint32_t*>(c);
  uint32_t x = 0;
  for (int b = 0; b < 4 && 4 * t + b < T; ++b) x |= uint32_t(c[b]) << (8 * b);
  return x;
}

// A loaded word as four staged code bytes: v = c + 1 (wire: c < 4
// always), or 0x81 for a byte code >= 4.
template <bool kWire>
__device__ __forceinline__ uint32_t stage_word(uint32_t x) {
  if (kWire)
    return ((x & 0x03u) | (x & 0x0Cu) << 6 | (x & 0x30u) << 12 |
            (x & 0xC0u) << 18) + 0x01010101u;
  const uint32_t ok = __vcmpltu4(x, 0x04040404u);  // 0xFF where c < 4
  return ((x & ok) + (ok & 0x01010101u)) | (~ok & 0x81818181u);
}

// Warp w of the grid takes rows [row0, row0 + 32 / lanes) and, of each,
// windows [c0, c0 + chunk), row0 = (w / chunks) * 32 / lanes and c0 =
// (w % chunks) * chunk (more than one chunk only at 32 lanes, one row).
template <bool kWire>
__global__ void __launch_bounds__(256)
window_hashes_kernel(const uint8_t* __restrict__ src,
                     const int32_t* __restrict__ lens, int64_t R, int64_t B,
                     int64_t W, int T, int L, int lanes, int run, int chunk,
                     int64_t chunks, uint32_t m1, uint32_t p1, uint32_t m2,
                     uint32_t p2, int32_t* __restrict__ q1,
                     int32_t* __restrict__ h2, uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows = 32 / lanes;  // rows a warp
  const int K = T - L + 1;
  const Layout lay(rows, chunk, L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t w = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  const int64_t row0 = w / chunks * rows;
  if (row0 >= R) return;
  const int c0 = static_cast<int>(w % chunks) * chunk;
  const int kc = min(chunk, K - c0);  // the warp's windows of each row
  const int nrows = R - row0 < rows ? static_cast<int>(R - row0) : rows;
  const int64_t e0 = row0 * K + c0;  // the warp's first output element
  // element e0 + i of an output is staged at index off + i, which puts
  // 16-byte aligned addresses of the output on 16-byte aligned ones here
  const int o1 = (reinterpret_cast<uintptr_t>(q1 + e0) >> 2) & 3;
  const int o2 = (reinterpret_cast<uintptr_t>(h2 + e0) >> 2) & 3;
  const int ov = reinterpret_cast<uintptr_t>(valid + e0) & 15;
  uint8_t* mine = smem + warp * lay.bytes(rows);
  uint32_t* s_q1 = reinterpret_cast<uint32_t*>(mine) + o1;
  uint32_t* s_h2 = reinterpret_cast<uint32_t*>(mine + lay.words) + o2;
  uint8_t* s_v = mine + 2 * lay.words + ov;
  uint32_t* s_code =
      reinterpret_cast<uint32_t*>(mine + 2 * lay.words + lay.flags);

  const int lg = __ffs(lanes) - 1;
  const int rr = lane >> lg, g = lane & (lanes - 1);
  int len = 0;
  if (rr < nrows) {
    const int64_t row = row0 + rr;
    if (kWire) {
      const int half = row < B ? 0 : 1;
      const uint8_t* tail = src + (row - half * B) * W + W - 4 + 2 * half;
      len = int(tail[0]) | (int(tail[1]) << 8);
    } else {
      len = lens[row];
    }
  }

  // unpack the warp's rows, kBatch loads a lane in flight
  const int sw = static_cast<int>(lay.stride / 4);  // words a row
  const int nw = nrows * sw;
  const float inv_sw = 1.0f / sw;
  const bool aligned =
      !kWire && (reinterpret_cast<uintptr_t>(src) & 3) == 0 && T % 4 == 0;
  for (int base = 0; base < nw; base += 32 * kBatch) {
    uint32_t x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + 32 * k + lane;
      x[k] = i < nw ? load_word<kWire>(src, row0, B, W, T, c0, sw, inv_sw,
                                       aligned, i)
                    : 0u;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + 32 * k + lane;
      if (i < nw) s_code[i] = stage_word<kWire>(x[k]);
    }
  }
  __syncwarp();

  const int j0 = g * run, j1 = min(kc, j0 + run);
  if (rr < nrows && j0 < j1) {
    const uint32_t* codes = s_code + rr * sw;
    const int srow = rr * kc;
    const int room = len - L - c0;  // window j lies inside the read: j <= room
    uint32_t a1 = kBias, a2 = 0;
    int nbad = 0;
    auto emit = [&](int j) {
      s_q1[srow + j] = a1;
      s_h2[srow + j] = a2;
      s_v[srow + j] = nbad == 0 && j <= room;
    };
    // the lane's first window by Horner's rule
    CodeStream first(codes, j0);
    int i = 0;
    for (; i + 4 <= L; i += 4) {
      const uint32_t x = first.next();
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        a1 = a1 * m1 + code_v(x, b);
        a2 = a2 * m2 + code_v(x, b);
      }
      if (!kWire) nbad += __popc(x & kBadBits);
    }
    if (i < L) {
      const uint32_t x = first.next();
      for (int b = 0; b < L - i; ++b) {
        a1 = a1 * m1 + code_v(x, b);
        a2 = a2 * m2 + code_v(x, b);
      }
      if (!kWire) nbad += __popc(x & (kBadBits >> (8 * (4 - (L - i)))));
    }
    emit(j0);
    // the rest of the run by rolling: code j - 1 leaves, j + L - 1 enters
    CodeStream out(codes, j0), in(codes, j0 + L);
    for (int j = j0 + 1; j < j1; j += 4) {
      const uint32_t xo = out.next(), xi = in.next();
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j + b < j1) {
          const uint32_t vo = code_v(xo, b), vi = code_v(xi, b);
          a1 = (a1 - vo * p1) * m1 + vi;
          a2 = (a2 - vo * p2) * m2 + vi;
          if (!kWire)
            nbad += int((xi >> (8 * b + 7)) & 1u) -
                    int((xo >> (8 * b + 7)) & 1u);
          emit(j + b);
        }
      }
    }
  }
  __syncwarp();

  const int n = nrows * kc;
  store_range(reinterpret_cast<uint32_t*>(q1) + e0, s_q1 - o1, o1, n, lane);
  store_range(reinterpret_cast<uint32_t*>(h2) + e0, s_h2 - o2, o2, n, lane);
  store_range(valid + e0, s_v - ov, ov, n, lane);
}

template <bool kWire>
int launch(const void* src, const void* lens, int64_t R, int64_t B,
           int64_t W, int64_t T, int64_t L, int64_t m1, int64_t p1,
           int64_t m2, int64_t p2, void* q1, void* h2, void* valid,
           void* stream) {
  if (R <= 0) return cudaSuccess;
  if (L <= 0 || L > T || T >= (int64_t(1) << 20))
    return cudaErrorInvalidValue;
  const Plan p = plan(T, L);
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = vt::allow_smem(window_hashes_kernel<kWire>, p.smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = 32 / p.lanes;
  const int64_t warps_total = (R + rows - 1) / rows * p.chunks;
  const int64_t blocks = (warps_total + p.warps - 1) / p.warps;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  window_hashes_kernel<kWire>
      <<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * p.warps),
         static_cast<size_t>(p.smem), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(src),
          static_cast<const int32_t*>(lens), R, B, W, static_cast<int>(T),
          static_cast<int>(L), p.lanes, p.run, p.chunk, p.chunks,
          static_cast<uint32_t>(m1), static_cast<uint32_t>(p1),
          static_cast<uint32_t>(m2), static_cast<uint32_t>(p2),
          static_cast<int32_t*>(q1), static_cast<int32_t*>(h2),
          static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // namespace

// wire: uint8 [B, W], W = 2*ceil(T/4) + 4 -> q1, h2 int32 [2B, K], valid
// uint8 [2B, K]. m1, p1, m2, p2: M_d and M_d^(L-1) mod 2^32 of each hash.
VT_EXPORT int vt_window_hashes_wire(const void* wire, int64_t B, int64_t W,
                                    int64_t T, int64_t L, int64_t m1,
                                    int64_t p1, int64_t m2, int64_t p2,
                                    void* q1, void* h2, void* valid,
                                    void* stream) {
  return launch<true>(wire, nullptr, 2 * B, B, W, T, L, m1, p1, m2, p2, q1,
                      h2, valid, stream);
}

// codes: uint8 [R, T], lens: int32 [R] -> q1, h2 int32 [R, K], valid
// uint8 [R, K]; the other arguments as for the wire feed.
VT_EXPORT int vt_window_hashes_bytes(const void* codes, const void* lens,
                                     int64_t R, int64_t T, int64_t L,
                                     int64_t m1, int64_t p1, int64_t m2,
                                     int64_t p2, void* q1, void* h2,
                                     void* valid, void* stream) {
  return launch<false>(codes, lens, R, 0, T, T, L, m1, p1, m2, p2, q1, h2,
                       valid, stream);
}
