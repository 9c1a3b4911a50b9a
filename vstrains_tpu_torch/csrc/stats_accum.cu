// Per-(read, node) hit count and lowest window index from per-slot node ids.
//
// Replaces vstrains_tpu/ops/pallas_kernels.py::stats_accum_pallas (kernel
// _stats_accum_kernel), and its XLA counterpart
// ops/pe_infer.py::_slots_scatter_accum.
//
// node_t: int32 [R, C], C = K * D. Slot j of row r holds the node matched
// by window j / D at duplicate rank j % D, or the sentinel N for a miss
// (any id outside [0, N) is a miss). Outputs, int32 [R, N]:
//   cnt[r, n]  = number of slots of row r holding n,
//   kmin[r, n] = min over those slots of j / D, INT32_MAX where cnt is 0.
//
// What bounds it on the card: bytes. It reads node_t (R*C*4 bytes, C up to
// K*16) and writes 2*R*N*4 bytes; the work in between is one atomic per
// hit slot. At the HIV shape (R = 32,768, C = 200*D, N = 773) the writes,
// 203 MB, dominate. Design: one block per row. The TPU kernel compared
// every slot against every node (a one-hot over N lanes, C*N compares per
// row, held in VMEM); here each slot is one shared-memory atomicAdd and
// atomicMin on its node's counters, so the work is C per row whatever N
// is. The row's counters live in shared memory while 2*N*4 bytes fit the
// default 48 KB (N <= 6144) and are written out once, coalesced; beyond
// that the block zeroes its output row and runs the same atomics on global
// memory, so there is no bound on N.

#include "vt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemBudget = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
stats_accum_shared(const int32_t* __restrict__ node_t, int64_t C, int depth,
                   int N, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ kmin) {
  extern __shared__ int32_t s_acc[];
  int32_t* s_cnt = s_acc;
  int32_t* s_kmin = s_acc + N;
  const int64_t r = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    s_cnt[n] = 0;
    s_kmin[n] = vt::kInf;
  }
  __syncthreads();
  const int32_t* row = node_t + r * C;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    const int32_t n = row[j];
    if (static_cast<uint32_t>(n) < static_cast<uint32_t>(N)) {
      atomicAdd(&s_cnt[n], 1);
      atomicMin(&s_kmin[n], static_cast<int32_t>(j / depth));
    }
  }
  __syncthreads();
  int32_t* crow = cnt + r * N;
  int32_t* krow = kmin + r * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    crow[n] = s_cnt[n];
    krow[n] = s_kmin[n];
  }
}

__global__ void __launch_bounds__(kThreads)
stats_accum_global(const int32_t* __restrict__ node_t, int64_t C, int depth,
                   int N, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ kmin) {
  const int64_t r = blockIdx.x;
  int32_t* crow = cnt + r * N;
  int32_t* krow = kmin + r * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    crow[n] = 0;
    krow[n] = vt::kInf;
  }
  // the barrier makes the block's global writes visible to the block
  __syncthreads();
  const int32_t* row = node_t + r * C;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    const int32_t n = row[j];
    if (static_cast<uint32_t>(n) < static_cast<uint32_t>(N)) {
      atomicAdd(&crow[n], 1);
      atomicMin(&krow[n], static_cast<int32_t>(j / depth));
    }
  }
}

}  // namespace

// 1 when (R, N) takes the shared-memory branch, 0 for global atomics.
VT_EXPORT int vt_stats_accum_uses_shared(int64_t N) {
  return 2 * N * static_cast<int64_t>(sizeof(int32_t)) <= kSmemBudget;
}

VT_EXPORT int vt_stats_accum(const void* node_t, int64_t R, int64_t C,
                             int64_t depth, int64_t N, void* cnt,
                             void* kmin, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int32_t*>(node_t);
  auto* c = static_cast<int32_t*>(cnt);
  auto* k = static_cast<int32_t*>(kmin);
  const unsigned grid = static_cast<unsigned>(R);
  if (vt_stats_accum_uses_shared(N)) {
    const size_t smem = 2 * N * sizeof(int32_t);
    stats_accum_shared<<<grid, kThreads, smem, s>>>(
        in, C, static_cast<int>(depth), static_cast<int>(N), c, k);
  } else {
    stats_accum_global<<<grid, kThreads, 0, s>>>(
        in, C, static_cast<int>(depth), static_cast<int>(N), c, k);
  }
  return cudaGetLastError();
}
