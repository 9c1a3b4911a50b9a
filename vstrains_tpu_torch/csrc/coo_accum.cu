// The sparse PE engine's link keys, counted on the card: each batch's
// saturated-node lists expanded into pair and same-end link keys, added
// into two open-addressing hash tables that live for the whole pass.
//
// Replaces no TPU kernel: the JAX package expands these keys on the host
// (vstrains_tpu/ops/pe_infer.py:1431, _sparse_pairs_np), makes each batch's
// unique and merges the batches at the end (:1458, _merge_coo); the port's
// plain version (ops/cuda_kernels.py::coo_accum_plain) still does.
//
// Input: out int32 [2B, cap] (rows `ld` apart: the tail's lists are a
// slice of a wider plane), rows 0..B-1 the forward read ends and B..2B-1
// the reverse ones, each row its saturated node ids ascending, then -1s.
// For pair p with forward ids f[0..nf) and reverse ids r[0..nr) the keys,
// u * N + v in 64 bits, are f[i] * N + r[j] for every (i, j) (the pair
// table) and f[i] * N + f[j], r[i] * N + r[j] for i <= j (the short
// table): exactly the keys _sparse_pairs_np makes. Each table is `slots`
// (a power of two) 16-byte slots (key, count), key kEmpty where free. A key
// lives at the first slot from hash(key) on whose key is its own or was
// free (linear probing); the slot is claimed with a 64-bit atomicCAS and
// its count raised with a 64-bit atomicAdd, so keys are never dropped or
// doubled. A key that finds every slot taken raises the table's full flag:
// the driver restarts the pass at 4x (it grows a table 4x, coo_rehash,
// long before, once half its slots are taken). stats, int64
// (cuda_kernels.COO_*): the batch's cap-overflow flag (an overflowed
// batch adds nothing; the pass ends there), the keys expanded so far, each
// table's claimed slots and full flag.
//
// What bounds it on the card: L2 atomics, not HBM. The lists are
// 2B * cap * 4 bytes (2 MB at B = 16,384, cap 16); the tables' live keys,
// ~190,000 at the hcmv3 cell, a few MB, sit in the 50 MB L2, and every
// expanded key (~400,000 a batch there) is a slot read and an atomic add
// in L2. Keys repeat: each ~22x (pair) and ~87x (short) over a pass, and
// neighbouring reads of a batch tend to share their nodes. Design: one
// lane a read pair, walking its keys in one fixed order (pair keys row by
// row, then the forward and the reverse same-end keys), so that at each
// step lanes whose pairs share nodes hold equal keys; __match_any_sync
// groups equal (key, table) values and the group's lowest lane adds the
// group's count once. A slot is read (from L2) before it is claimed, so a
// key already there costs one load and one fire-and-forget add. Each warp
// sums its lanes' keys and claims and adds them to the counters once.

#include "vt_common.cuh"

namespace {

constexpr int kThreads = 64;  // pairs a block: 256 blocks at B = 16,384
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kEmpty = 0x7fffffffffffffffull;
constexpr unsigned long long kHashMul = 0x9e3779b97f4a7c15ull;
// cuda_kernels.COO_OVF, COO_KEYS, COO_FILL (pair, short), COO_FULL (pair,
// short)
constexpr int kOvf = 0, kKeys = 1, kFill = 2, kFullFlag = 4;

// Adds cnt to key's slot of the table (1 << bits slots), claiming a free
// slot when the key has none. Returns 1 when it claimed a slot, 0 when the
// key was there, and -1, with the table's full flag raised, when every
// slot holds another key or another key found the table full first.
__device__ int insert(unsigned long long* tab, int bits,
                      unsigned long long key, unsigned long long cnt,
                      long long* full) {
  const unsigned long long mask = (1ull << bits) - 1;
  unsigned long long s = (key * kHashMul) >> (64 - bits);
  for (unsigned long long probe = 0; probe <= mask; ++probe) {
    unsigned long long* slot = tab + 2 * s;
    unsigned long long k = __ldcg(slot);
    if (k == kEmpty) k = atomicCAS(slot, kEmpty, key);
    if (k == kEmpty || k == key) {
      atomicAdd(slot + 1, cnt);
      return k == kEmpty;
    }
    // a long probe looks whether another key found the table full
    if ((probe & 1023) == 1023 &&
        *reinterpret_cast<volatile long long*>(full))
      return -1;
    s = (s + 1) & mask;
  }
  *reinterpret_cast<volatile long long*>(full) = 1;
  return -1;
}

__global__ void __launch_bounds__(kThreads)
coo_accum_kernel(const int32_t* __restrict__ out, int64_t B, int cap,
                 int64_t ld, long long N, unsigned long long* pair_tab,
                 int pair_bits, unsigned long long* short_tab, int short_bits,
                 const bool* __restrict__ ovf, long long* stats) {
  const bool aborted = *ovf;
  if (blockIdx.x == 0 && threadIdx.x == 0) stats[kOvf] = aborted;
  if (aborted) return;
  const int lane = threadIdx.x & 31;
  const int64_t p = blockIdx.x * static_cast<int64_t>(kThreads) +
                    threadIdx.x;
  const int32_t* f = out + p * ld;
  const int32_t* r = out + (B + p) * ld;
  int nf = 0, nr = 0;
  if (p < B) {
    while (nf < cap && __ldg(f + nf) >= 0) ++nf;
    while (nr < cap && __ldg(r + nr) >= 0) ++nr;
  }
  const int total = nf * nr + nf * (nf + 1) / 2 + nr * (nr + 1) / 2;
  // a full table stops the pass's inserts (the pass restarts), not its
  // count of keys; the warp agrees on it, so that its lanes take the same
  // number of steps
  const bool full = stats[kFullFlag] | stats[kFullFlag + 1];
  const int steps =
      __any_sync(kAll, full) ? 0 : __reduce_max_sync(kAll, total);
  // the walk: phase 0 pair keys (i, j) over nf x nr; phase 1 forward and
  // phase 2 reverse same-end keys, i <= j
  int phase = nf * nr ? 0 : (nf ? 1 : 2);
  int i = 0, j = 0;
  unsigned claimed_pair = 0, claimed_short = 0;
  for (int step = 0; step < steps; ++step) {
    const bool active = step < total;
    const unsigned lanes = __ballot_sync(kAll, active);
    if (active) {
      const int32_t* a = phase == 2 ? r : f;
      const int32_t* b = phase == 1 ? f : r;
      const unsigned long long key =
          static_cast<unsigned long long>(__ldg(a + i)) * N + __ldg(b + j);
      const int t = phase != 0;
      const unsigned group = __match_any_sync(lanes, (key << 1) | t);
      if (lane == __ffs(group) - 1) {
        const int got =
            t ? insert(short_tab, short_bits, key, __popc(group),
                       stats + kFullFlag + 1)
              : insert(pair_tab, pair_bits, key, __popc(group),
                       stats + kFullFlag);
        (t ? claimed_short : claimed_pair) += got > 0;
      }
      if (phase == 0) {
        if (++j == nr) {
          j = 0;
          if (++i == nf) {
            phase = 1;
            i = 0;
          }
        }
      } else if (++j == (phase == 1 ? nf : nr)) {
        if (++i == (phase == 1 ? nf : nr)) {
          phase = 2;
          i = 0;
        }
        j = i;
      }
    }
  }
  const unsigned keys = __reduce_add_sync(kAll, total);
  claimed_pair = __reduce_add_sync(kAll, claimed_pair);
  claimed_short = __reduce_add_sync(kAll, claimed_short);
  if (lane == 0) {
    auto* st = reinterpret_cast<unsigned long long*>(stats);
    if (keys) atomicAdd(st + kKeys, keys);
    if (claimed_pair) atomicAdd(st + kFill, claimed_pair);
    if (claimed_short) atomicAdd(st + kFill + 1, claimed_short);
  }
}

// Every key of a table, with its count, into an empty table of
// 1 << new_bits slots (4x: never full).
__global__ void coo_rehash_kernel(const unsigned long long* __restrict__ old,
                                  int64_t old_slots, unsigned long long* tab,
                                  int new_bits, long long* full) {
  const int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (s >= old_slots) return;
  const unsigned long long key = old[2 * s];
  if (key != kEmpty) insert(tab, new_bits, key, old[2 * s + 1], full);
}

}  // namespace

VT_EXPORT int vt_coo_accum(const void* out, int64_t B, int64_t cap,
                           int64_t ld, int64_t N, void* pair_tab,
                           int64_t pair_bits, void* short_tab,
                           int64_t short_bits,
                           const void* ovf, void* stats, void* stream) {
  // one block even at B = 0: it records the batch's overflow flag
  const unsigned grid =
      static_cast<unsigned>(B > 0 ? (B + kThreads - 1) / kThreads : 1);
  coo_accum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(out), B, static_cast<int>(cap), ld,
      static_cast<long long>(N), static_cast<unsigned long long*>(pair_tab),
      static_cast<int>(pair_bits),
      static_cast<unsigned long long*>(short_tab),
      static_cast<int>(short_bits), static_cast<const bool*>(ovf),
      static_cast<long long*>(stats));
  return cudaGetLastError();
}

VT_EXPORT int vt_coo_rehash(const void* old, int64_t old_slots, void* tab,
                            int64_t new_bits, void* full, void* stream) {
  if (old_slots <= 0) return cudaSuccess;
  constexpr int kRehashThreads = 256;
  const unsigned grid = static_cast<unsigned>(
      (old_slots + kRehashThreads - 1) / kRehashThreads);
  coo_rehash_kernel<<<grid, kRehashThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(old), old_slots,
      static_cast<unsigned long long*>(tab), static_cast<int>(new_bits),
      static_cast<long long*>(full));
  return cudaGetLastError();
}
