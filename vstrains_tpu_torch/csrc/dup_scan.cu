// The classic probe's duplicate-run scan on the sparse engine: per-slot
// (node, window index) planes, the sparse tail's input.
//
// The port's own kernel for an XLA stage of the JAX package (no Pallas
// kernel there): vstrains_tpu/ops/pe_infer.py::_sparse_expand_matches.
//
// Inputs, per window w of R x K (row-major): q1, h2, valid and lo as in
// dup_stats.cu; the padded table, sorted by h1, as interleaved records
// int32 [M, 4] (dup_walk.cuh). Outputs, int32 [R, K * D] each,
// slot w * D + d for window w = r * K + k at duplicate rank d:
//   node_key = the matched entry's node, kidx_v = k, where the window
//   matches at rank d by the JAX rule (dup_walk.cuh); INT32_MAX in both
//   planes for a miss.
//
// What bounds it on the card: bytes. It reads 13 bytes a window and the
// entries its walk needs, and writes 8 * D bytes a window: at the repeat
// cell's sparse batch (2B = 8,192, K = 95, D = 32) 199 MB of output; on
// the N = 300k cell's 2 GiB of records (D = 4) the walks' gathers miss
// L2. Design: a block owns kThreads consecutive windows, one a thread,
// and stages the windows' slots, which are one flat contiguous range of
// each plane, in shared memory: the block fills both staged planes with
// the sentinel, each thread walks its window once (dup_walk.cuh: it stops
// at the first entry past the equal-h1 run, and the ranks past it are the
// sentinel already, the table unread) and writes its matches, then the
// block stores both ranges in 16-byte vectors, so a warp's stores are
// whole contiguous lines at D = 4 as at D = 32. The staged planes sit
// congruent with their outputs modulo 16 bytes. All per-slot arithmetic is
// in 32-bit block-local indices over one 64-bit base a block.

#include "dup_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kSmemMax = 227 * 1024;

// shared words for `windows` windows of D slots in two staged planes,
// each placed congruent with its output and padded to whole quads
int64_t smem_bytes(int64_t windows, int64_t D) {
  return 4 * (2 * windows * D + 16);
}

// windows a block: kThreads, fewer where D slots a window would take more
// than the shared memory a block may have; 0 where one window does not fit
int64_t block_windows(int64_t D) {
  int64_t w = kThreads;
  while (w > 0 && smem_bytes(w, D) > kSmemMax) w /= 2;
  return w;
}

__global__ void __launch_bounds__(kThreads)
dup_scan_kernel(const int32_t* __restrict__ q1,
                const int32_t* __restrict__ h2,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ lo,
                const int4* __restrict__ tab, int64_t M,
                int64_t windows, int K, int D, int block_w,
                int32_t* __restrict__ node_key,
                int32_t* __restrict__ kidx_v) {
  extern __shared__ int4 s_raw[];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * block_w;
  const int nw = static_cast<int>(
      windows - w0 < block_w ? windows - w0 : block_w);
  const int span = nw * D;
  int32_t* out_node = node_key + w0 * D;
  int32_t* out_kidx = kidx_v + w0 * D;
  int32_t* s_node =
      vt::congruent(reinterpret_cast<int32_t*>(s_raw), out_node);
  int32_t* s_kidx = vt::congruent(vt::align16(s_node + span), out_kidx);
  vt::fill_shared(s_node, span, vt::kInf);
  vt::fill_shared(s_kidx, span, vt::kInf);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nw) {
    const int64_t w = w0 + t;
    const int32_t q = __ldg(q1 + w);
    const int32_t h = __ldg(h2 + w);
    const int64_t l = __ldg(lo + w);
    if (__ldg(valid + w)) {
      const int64_t loc = l < M - 1 ? l : M - 1;
      const int n = static_cast<int>(M - loc < D ? M - loc : D);
      const int k = static_cast<int>(w % K);
      int32_t* sn = s_node + t * D;
      int32_t* sk = s_kidx + t * D;
      vt::walk(tab, loc, n, q, h, [&](int d, int32_t node) {
        sn[d] = node;
        sk[d] = k;
      });
    }
  }
  __syncthreads();
  vt::store_flat(out_node, s_node, span);
  vt::store_flat(out_kidx, s_kidx, span);
}

}  // namespace

VT_EXPORT int vt_dup_scan(const void* q1, const void* h2, const void* valid,
                          const void* lo, const void* tab, int64_t windows,
                          int64_t K, int64_t D, int64_t M, void* node_key,
                          void* kidx_v, void* stream) {
  if (windows <= 0) return cudaSuccess;
  const int64_t bw = block_windows(D);
  if (K <= 0 || D <= 0 || M <= 0 || K > 0x7fffffff || bw < 1 ||
      (windows + bw - 1) / bw > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_bytes(bw, D));
  const cudaError_t err = vt::allow_smem(dup_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  dup_scan_kernel<<<static_cast<unsigned>((windows + bw - 1) / bw), kThreads,
                    smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q1), static_cast<const int32_t*>(h2),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(lo),
      static_cast<const int4*>(tab), M, windows, static_cast<int>(K),
      static_cast<int>(D), static_cast<int>(bw),
      static_cast<int32_t*>(node_key), static_cast<int32_t*>(kidx_v));
  return cudaGetLastError();
}
