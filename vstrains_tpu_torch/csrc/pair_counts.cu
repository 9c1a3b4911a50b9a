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
// What bounds it on the card: the least work is f^T r in full plus the
// upper triangle of f^T f + r^T r, 2*B*N^2 + 2*B*N*(N+1) integer
// operations (39.2 G at B = 16,384, N = 773), which the int8 tensor cores
// do in 0.0198 ms at 1,979 TOP/s; its bytes (25.3 MB of masks in, the two
// 4.8 MB accumulators read and written) take 0.0133 ms at 3.35 TB/s
// (H100 SXM published peaks at 700 W). Design:
//   * Products on the tensor cores in 8 bits: wgmma.mma_async m64n128k32
//     with .u8 operands and .s32 accumulators. Values are 0/1 and a
//     segment sums at most 2 * B reads per cell, so int32 partials are
//     exact.
//   * 8-bit wgmma reads only K-major operands (a node's reads contiguous)
//     and the masks are node-major, so the first launch (pack_words)
//     packs each node's 32 reads into one bit of a word: [B/32, N] words,
//     3.2 MB at the HIV shape, read as whole 16-byte words of each mask,
//     in node slices of kPackSlice so that any N launches.
//     The product kernel stages those words (cp.async, 4 bytes a row) and
//     expands them to bytes in shared memory with one multiply per nibble,
//     so the transpose costs nothing in its inner loop and the operands
//     it reads from L2 are 8x smaller than byte tiles: 26 MB instead of
//     205 MB over the launch at the HIV shape.
//   * Only the tiles that are needed: a segment owns one 128 x 128 tile
//     (I, J) with I <= J and one range of reads; it stages f_I, r_I, f_J,
//     r_J (f_I, r_I on the diagonal) and runs, per 32 reads and for each
//     of two warpgroups' 64 rows of I,
//       f_I^T r_J             -> acc_nm[I, J]
//       r_I^T f_J             -> acc_nm[J, I], written transposed (I < J)
//       f_I^T f_J + r_I^T r_J -> acc_sm[I, J], diagonal masked to i <= j
//     so no lower-triangle product of acc_sm is computed. The three
//     accumulators take 192 of a thread's registers.
//   * Split-K to fill the SMs (132 on the H100 SXM): N = 773 has only 28
//     such tiles, so one block per SM walks a run of equal cost through
//     the tiles' read steps (ops/cuda_kernels.py::pair_counts_schedule,
//     for the card's SM count: starts int32 [blocks + 1], segments int32
//     [n, 4] = (tile I, tile J, first read, end read), in the tile and
//     step the wrapper passes and the kernel checks). Each segment adds
//     its partial sums into the int64 accumulators with 64-bit atomic
//     adds, exact and order-free (zero partials are skipped); runs cross
//     tiles, so a tile is shared by a few blocks only. Rows past N are
//     zero-filled, never read.
//   * Pipelining: packed words arrive kAhead steps ahead; one barrier a
//     step publishes the expanded bytes (three byte slots, so a slot is
//     rewritten only after every warpgroup retired its products), and
//     one group of products stays in flight while the next is issued.
//     The bytes use the no-swizzle K-major layout of wgmma's core
//     matrices (8 rows x 16 bytes).
// Two warpgroups (256 threads) per block, one block per SM.

#include "vt_common.cuh"

namespace {

constexpr int kTile = 128;        // output tile edge
constexpr int kGroups = 2;        // warpgroups: 64 rows of the tile each
constexpr int kThreads = 128 * kGroups;
constexpr int kWords = 4;         // packed words (32 reads each) a step
constexpr int kBitStages = 4;     // ring of packed words, per thread
constexpr int kAhead = 2;         // steps of words loaded ahead
constexpr int kByteStages = 3;    // ring of expanded operand bytes
constexpr int kOperandBytes = kTile * 32 * kWords;  // one operand tile
constexpr int kByteSlot = 4 * kOperandBytes;       // f_I r_I f_J r_J
constexpr int kBitSlot = 4 * kTile * 4 * kWords;   // their packed words
constexpr int kSmemBytes = kByteStages * kByteSlot + kBitStages * kBitSlot;
constexpr int kChunkStride = kTile / 8 * 128;      // next 16 B of K
constexpr int kAcc = kTile / 2;   // accumulator registers per product
constexpr int kPackThreads = 256;
constexpr int kPackLoads = 4;     // 16-byte loads in flight per mask
constexpr int kPackSlice = 8192;  // nodes a packing block owns (64 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes (nothing read) when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wgmma matrix descriptor of a K-major operand without swizzle: start
// address, leading byte offset (next 16-byte chunk along K) and stride
// byte offset (next 8 rows), each in 16-byte units; layout type 0.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kChunkStride >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// bytes 0..3 := bits 0..3 of a nibble (0 or 1 each)
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// d[64 x 128] += a[64 x 32] * b[128 x 32]^T over unsigned bytes; d is
// the warpgroup's accumulator fragment (64 int32 per thread).
__device__ __forceinline__ void mma_u8(int32_t (&d)[kAcc], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Keeps the compiler from moving an accumulator across the asynchronous
// products (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void hold(int32_t (&d)[kAcc]) {
#pragma unroll
  for (int e = 0; e < kAcc; ++e) asm volatile("" : "+r"(d[e])::"memory");
}

__device__ __forceinline__ void add_count(int64_t* acc, int64_t o,
                                          int32_t v) {
  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(acc + o),
              static_cast<unsigned long long>(v));
}

// For each nonzero byte of `part` (the 4 bytes at address a) inside the
// word row's range [lo, hi) and the block's node slice [n0, n0 + S): set
// its read's bit in its node's word.
__device__ __forceinline__ void set_bits(uint32_t part, uintptr_t a,
                                         uintptr_t lo, uintptr_t hi, int N,
                                         int n0, int S, uint32_t* row_words) {
  uint32_t m = __vcmpne4(part, 0u);  // 0xff in each nonzero byte
  while (m != 0) {
    const int k = (__ffs(m) - 1) >> 3;
    m &= ~(0xffu << (8 * k));
    const uintptr_t p = a + k;
    if (p < lo || p >= hi) continue;
    const int off = static_cast<int>(p - lo);  // < 32 N < 2^31
    const int b = off / N;
    const int n = off - b * N - n0;
    if (static_cast<unsigned>(n) < static_cast<unsigned>(S))
      atomicOr(&row_words[n], 1u << b);
  }
}

// f, r [B, N] -> fw, rw [W, N]: word w of node n packs reads 32 w ..
// 32 w + 31 (bit k = read 32 w + k), zero past B. Block (w, y) makes
// word row w of nodes [y kPackSlice, (y + 1) kPackSlice): the 32 reads
// are one contiguous byte range of each mask, read as the aligned
// 16-byte words that cover it (every word holds a byte of the range, so
// no read leaves the tensor's pages); each nonzero byte of the slice
// sets its bit in the block's word row in shared memory, which then
// leaves coalesced. Masks are sparse, so most words are all zero. Past
// one slice (N > kPackSlice) each slice's block reads the whole range:
// that is O(B N^2 / kPackSlice) bytes against the products' O(B N^2).
__global__ void __launch_bounds__(kPackThreads)
pack_words(const uint8_t* __restrict__ f, const uint8_t* __restrict__ r,
           int64_t B, int N, uint32_t* __restrict__ fw,
           uint32_t* __restrict__ rw) {
  extern __shared__ uint32_t row_words[];  // [2][S]
  const int64_t w = blockIdx.x;
  const int n0 = blockIdx.y * kPackSlice;
  const int S = N - n0 < kPackSlice ? N - n0 : kPackSlice;
  for (int n = threadIdx.x; n < 2 * S; n += kPackThreads) row_words[n] = 0;
  __syncthreads();
  const int64_t b0 = w * 32;
  const int64_t b1 = B < b0 + 32 ? B : b0 + 32;
  if (b0 < b1) {
    const uint8_t* src[2] = {f, r};
    uintptr_t lo[2], hi[2], a0[2];
    int count = 0;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      lo[x] = reinterpret_cast<uintptr_t>(src[x] + b0 * N);
      hi[x] = reinterpret_cast<uintptr_t>(src[x] + b1 * N);
      a0[x] = lo[x] & ~uintptr_t{15};
      const int c = static_cast<int>((hi[x] - a0[x] + 15) / 16);
      count = c > count ? c : count;
    }
    // kPackLoads words of each mask in flight a thread before any is used
    for (int q0 = threadIdx.x; q0 < count; q0 += kPackThreads * kPackLoads) {
      uint4 v[2][kPackLoads];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int u = 0; u < kPackLoads; ++u) {
          const uintptr_t a = a0[x] + 16 * (q0 + u * kPackThreads);
          v[x][u] = a < hi[x] ? *reinterpret_cast<const uint4*>(a)
                              : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int u = 0; u < kPackLoads; ++u) {
          const uintptr_t a = a0[x] + 16 * (q0 + u * kPackThreads);
          const uint32_t part[4] = {v[x][u].x, v[x][u].y, v[x][u].z,
                                    v[x][u].w};
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            set_bits(part[k4], a + 4 * k4, lo[x], hi[x], N, n0, S,
                     row_words + x * S);
        }
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < S; n += kPackThreads) {
    fw[w * N + n0 + n] = row_words[n];
    rw[w * N + n0 + n] = row_words[S + n];
  }
}

// One block per SM walks its segments (tile I, tile J, first read, end
// read) of the work list, starts[blockIdx.x] .. starts[blockIdx.x + 1].
// A step is kWords words (32 reads each) of the four operand tiles: their
// packed words arrive by cp.async kAhead steps ahead, each thread expands
// the words it loaded into bytes in wgmma's layout, and one barrier a
// step publishes them; a group of products stays in flight meanwhile.
__global__ void __launch_bounds__(kThreads, 1)
pair_counts_kernel(const uint32_t* __restrict__ fw,
                   const uint32_t* __restrict__ rw, int N,
                   const int* __restrict__ starts,
                   const int4* __restrict__ segs, int64_t* acc_nm,
                   int64_t* acc_sm) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bytes = smem_addr(smem);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kByteStages * kByteSlot);
  const int t = threadIdx.x;
  const int group = t >> 7;  // this warpgroup's 64 rows of the I tile
  const int warp = (t >> 5) & 3, lane = t & 31;
  // the (operand, row) words this thread loads and expands: operands
  // o = t / 128 and o + 2 (f_I or r_I, then f_J or r_J), row t % 128
  const int row = t & (kTile - 1);
  const uint32_t* plane = (t >> 7) ? rw : fw;

  for (int g = starts[blockIdx.x]; g < starts[blockIdx.x + 1]; ++g) {
    const int4 seg = segs[g];
    const int i0 = seg.x * kTile, j0 = seg.y * kTile;
    const bool diag = seg.x == seg.y;
    const int nops = diag ? 1 : 2;  // operands this thread handles
    const int steps = (seg.w - seg.z) / (32 * kWords);
    const int64_t w0 = seg.z / 32;

    auto load = [&](int step) {
      uint32_t* slot = bits + (step % kBitStages) * (kBitSlot / 4);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nops) break;
        const int n = (q == 0 ? i0 : j0) + row;
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          cp_async4(smem_addr(slot + ((q * 2 + (t >> 7)) * kWords + k) *
                                         kTile + row),
                    plane + (w0 + step * kWords + k) * N + (n < N ? n : 0),
                    n < N);
      }
    };
    auto expand = [&](int step) {
      const uint32_t* slot = bits + (step % kBitStages) * (kBitSlot / 4);
      uint8_t* dst = smem + (step % kByteStages) * kByteSlot;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nops) break;
        const int o = q * 2 + (t >> 7);
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const uint32_t v = slot[(o * kWords + k) * kTile + row];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t h = v >> (16 * half);
            *reinterpret_cast<uint4*>(dst + o * kOperandBytes +
                                      (2 * k + half) * kChunkStride +
                                      row * 16) =
                make_uint4(nibble_bytes(h & 15), nibble_bytes((h >> 4) & 15),
                           nibble_bytes((h >> 8) & 15),
                           nibble_bytes((h >> 12) & 15));
          }
        }
      }
    };

    int32_t nm[kAcc], mn[kAcc], sm[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) nm[e] = mn[e] = sm[e] = 0;

    __syncthreads();  // the last segment's products are done with smem
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s < steps) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kAhead - 1>();  // this thread's words of step s
      if (s + kAhead < steps) load(s + kAhead);
      cp_async_commit();
      // byte slot s % 3 was last read by the products of step s - 3,
      // which every thread retired before the last barrier
      expand(s);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t st = bytes + (s % kByteStages) * kByteSlot;
      const uint32_t rows = group * (kTile / 2 / 8) * 128;
      const uint32_t fI = st + rows, rI = st + kOperandBytes + rows;
      const uint32_t fJ = diag ? st : st + 2 * kOperandBytes;
      const uint32_t rJ = diag ? st + kOperandBytes : st + 3 * kOperandBytes;
      hold(nm);
      hold(mn);
      hold(sm);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const uint32_t off = k * 2 * kChunkStride;
        mma_u8(nm, operand_desc(fI + off), operand_desc(rJ + off));
        if (!diag)
          mma_u8(mn, operand_desc(rI + off), operand_desc(fJ + off));
        mma_u8(sm, operand_desc(fI + off), operand_desc(fJ + off));
        mma_u8(sm, operand_desc(rI + off), operand_desc(rJ + off));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      hold(nm);
      hold(mn);
      hold(sm);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(nm);
    hold(mn);
    hold(sm);

    // accumulator fragment: warp w of the group holds rows 16w .. 16w + 15
    // of its 64; register 4 * n8 + h is row 16w + lane / 4 + 8 * (h / 2),
    // column 8 * n8 + 2 * (lane % 4) + h % 2
#pragma unroll
    for (int n8 = 0; n8 < kTile / 8; ++n8) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int e = 4 * n8 + h;
        const int i = i0 + group * 64 + warp * 16 + (lane >> 2) +
                      ((h >> 1) << 3);
        const int j = j0 + 8 * n8 + 2 * (lane & 3) + (h & 1);
        if (i >= N || j >= N) continue;
        add_count(acc_nm, static_cast<int64_t>(i) * N + j, nm[e]);
        if (!diag)
          add_count(acc_nm, static_cast<int64_t>(j) * N + i, mn[e]);
        if (i <= j)
          add_count(acc_sm, static_cast<int64_t>(i) * N + j, sm[e]);
      }
    }
  }
}

}  // namespace

// f, r: uint8 [B, N] (row stride N); starts: int32 [blocks + 1] and
// segs: int32 [segments, 4], the work list (device), in tiles of `tile`
// nodes and read ranges of whole steps of `step` reads (another tile or
// step is refused: the list would index other tiles); words: uint32
// scratch of 2 * W * N entries, W = ceil(B / (32 kWords)) * kWords;
// acc_nm, acc_sm: int64 [N, N].
VT_EXPORT int vt_pair_counts(const void* f, const void* r, int64_t B,
                             int64_t N, const void* starts, int64_t blocks,
                             const void* segs, int64_t tile, int64_t step,
                             void* words, void* acc_nm, void* acc_sm,
                             void* stream) {
  if (tile != kTile || step != 32 * kWords) return cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || blocks <= 0) return cudaSuccess;
  const int64_t W = (B + 32 * kWords - 1) / (32 * kWords) * kWords;
  const int64_t slices = (N + kPackSlice - 1) / kPackSlice;
  // grid limits of the two launches, and a word row's byte offsets in int
  if (W > 0x7fffffff || slices > 65535 || blocks > 0x7fffffff ||
      N > (int64_t{1} << 26))
    return cudaErrorInvalidConfiguration;
  const size_t pack_smem =
      2 * (N < kPackSlice ? N : kPackSlice) * sizeof(uint32_t);
  auto s = static_cast<cudaStream_t>(stream);
  auto* fw = static_cast<uint32_t*>(words);
  auto* rw = fw + W * N;
  cudaError_t err = vt::allow_smem(pack_words, pack_smem);
  if (err != cudaSuccess) return err;
  const dim3 pack_grid(static_cast<unsigned>(W),
                       static_cast<unsigned>(slices));
  pack_words<<<pack_grid, kPackThreads, pack_smem, s>>>(
      static_cast<const uint8_t*>(f), static_cast<const uint8_t*>(r), B,
      static_cast<int>(N), fw, rw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = vt::allow_smem(pair_counts_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  pair_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                       s>>>(fw, rw, static_cast<int>(N),
                            static_cast<const int*>(starts),
                            static_cast<const int4*>(segs),
                            static_cast<int64_t*>(acc_nm),
                            static_cast<int64_t*>(acc_sm));
  return cudaGetLastError();
}
