// Native k-mer table build: the host-side hot path of
// ops/pe_infer.build_kmer_table (hash both strands of every node, sort by
// (h1, h2, node, offset)) in multithreaded C++.
//
// Bit-identical contract with the numpy path:
//   * hash lane: h = sum_t (code[t]+1) * M^(L-1-t) mod 2^32 for the two odd
//     multipliers in core/seq.py (natural uint32 wrap-around) — computed
//     here as a rolling hash, which is the same value mod 2^32.
//   * a window is valid iff it contains no non-ACGT (uppercase) byte.
//   * the reverse-complement window at rc-position j of a length-n node
//     records the forward offset n - L - j (PE_Inference.py:123-135 parity).
//   * final order is lexicographic by (packed (h1,h2) key, node, offset) —
//     exactly what the numpy path's stable sort + tie canonization yields,
//     so the result is independent of input order and of this file's
//     bucketing strategy.
//
// Replaces ~3.7 s of vectorized numpy (metaSPAdes scale, 14.5M entries)
// with a few hundred ms; the numpy path remains as the fallback and as the
// A/B oracle (tests/test_table_native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t MULT1 = 0x9E3779B1u;
constexpr uint32_t MULT2 = 0x85EBCA77u;
constexpr uint8_t BAD = 255;

struct Entry {
  uint64_t key;  // (h1 << 32) | h2
  uint64_t tie;  // (node << 32) | offset (both non-negative int32)
};

inline uint32_t pow_mod32(uint32_t m, uint64_t e) {
  uint32_t r = 1, b = m;
  while (e) {
    if (e & 1) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

struct EncTable {
  uint8_t enc[256];
  EncTable() {
    std::memset(enc, BAD, sizeof(enc));
    enc[uint8_t('A')] = 0;
    enc[uint8_t('C')] = 1;
    enc[uint8_t('G')] = 2;
    enc[uint8_t('T')] = 3;
  }
};
const EncTable kEnc;

// Count valid length-L windows of codes[0..n).
inline int64_t count_valid(const uint8_t* codes, int64_t n, int32_t L) {
  if (n < L) return 0;
  int64_t cnt = 0, last_bad = -1;
  for (int64_t p = 0; p < n; ++p) {
    if (codes[p] >= 4) last_bad = p;
    if (p >= L - 1 && last_bad < p - L + 1) ++cnt;
  }
  return cnt;
}

// Rolling dual hash over codes[0..n); for each valid window j emit an
// Entry with offset off(j) into out (advancing cursor).
template <typename OffFn>
inline Entry* hash_strand(const uint8_t* codes, int64_t n, int32_t L,
                          uint32_t ml1, uint32_t ml2, int32_t node_id,
                          OffFn off, Entry* out) {
  if (n < L) return out;
  uint32_t h1 = 0, h2 = 0;
  int64_t last_bad = -1;
  for (int32_t t = 0; t < L; ++t) {
    uint8_t c = codes[t];
    if (c >= 4) last_bad = t;
    uint32_t u = (c < 4) ? uint32_t(c) + 1u : 1u;
    h1 = h1 * MULT1 + u;
    h2 = h2 * MULT2 + u;
  }
  const uint64_t node_hi = uint64_t(uint32_t(node_id)) << 32;
  for (int64_t j = 0;; ++j) {
    if (last_bad < j) {
      out->key = (uint64_t(h1) << 32) | uint64_t(h2);
      out->tie = node_hi | uint64_t(uint32_t(off(j)));
      ++out;
    }
    if (j == n - L) break;
    uint8_t cold = codes[j], cnew = codes[j + L];
    if (cnew >= 4) last_bad = j + L;
    uint32_t uold = (cold < 4) ? uint32_t(cold) + 1u : 1u;
    uint32_t unew = (cnew < 4) ? uint32_t(cnew) + 1u : 1u;
    h1 = (h1 - uold * ml1) * MULT1 + unew;
    h2 = (h2 - uold * ml2) * MULT2 + unew;
  }
  return out;
}

}  // namespace

extern "C" int64_t tb_build(const uint8_t* ascii, const int64_t* starts,
                            const int32_t* lens, const int32_t* ids,
                            int64_t nb, int32_t L, int32_t nthreads,
                            uint32_t* h1o, uint32_t* h2o, int32_t* nodeo,
                            int32_t* offo, int64_t cap,
                            int64_t* max_dup_out) {
  const bool prof = std::getenv("VSTRAINS_TB_PROFILE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "tb_build %-10s %.3fs\n", name,
                 std::chrono::duration<double>(now - tick).count());
    tick = now;
  };
  if (L <= 0 || nb < 0) return -2;
  if (nthreads < 1) nthreads = 1;
  const uint32_t ml1 = pow_mod32(MULT1, uint64_t(L) - 1);
  const uint32_t ml2 = pow_mod32(MULT2, uint64_t(L) - 1);

  // ---- phase A: encode + exact valid-window count per node ------------
  // (encode once into a shared code buffer so phase B re-reads codes, not
  // ASCII; rc codes are derived per node in scratch)
  int64_t total_codes = 0;
  for (int64_t i = 0; i < nb; ++i) total_codes += lens[i];
  std::vector<uint8_t> codes(static_cast<size_t>(total_codes));
  std::vector<int64_t> cstart(static_cast<size_t>(nb) + 1);
  cstart[0] = 0;
  for (int64_t i = 0; i < nb; ++i) cstart[i + 1] = cstart[i] + lens[i];
  std::vector<int64_t> vc(static_cast<size_t>(nb));

  auto run_nodes = [&](auto&& fn) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= nb) return;
        fn(i);
      }
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nthreads; ++t) th.emplace_back(worker);
    worker();
    for (auto& t : th) t.join();
  };

  run_nodes([&](int64_t i) {
    const uint8_t* src = ascii + starts[i];
    uint8_t* dst = codes.data() + cstart[i];
    int64_t n = lens[i];
    for (int64_t p = 0; p < n; ++p) dst[p] = kEnc.enc[src[p]];
    vc[i] = count_valid(dst, n, L);
  });

  lap("count");
  std::vector<int64_t> pref(static_cast<size_t>(nb) + 1);
  pref[0] = 0;
  for (int64_t i = 0; i < nb; ++i) pref[i + 1] = pref[i] + vc[i];
  const int64_t M = 2 * pref[nb];
  if (M > cap) return -1;
  if (max_dup_out) *max_dup_out = (M == 0) ? 1 : 0;
  if (M == 0) return 0;

  // ---- phase B: fill entries (fwd + rc per node) ----------------------
  std::vector<Entry> ent(static_cast<size_t>(M));
  {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      std::vector<uint8_t> rc;
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= nb) return;
        int64_t n = lens[i];
        if (!vc[i]) continue;
        const uint8_t* c = codes.data() + cstart[i];
        Entry* base = ent.data() + 2 * pref[i];
        Entry* end1 = hash_strand(c, n, L, ml1, ml2, ids[i],
                                  [](int64_t j) { return j; }, base);
        (void)end1;
        rc.resize(size_t(n));
        for (int64_t p = 0; p < n; ++p) {
          uint8_t b = c[n - 1 - p];
          rc[p] = (b < 4) ? uint8_t(3 - b) : BAD;
        }
        // rc window j  <->  forward offset n - L - j
        hash_strand(rc.data(), n, L, ml1, ml2, ids[i],
                    [n, L](int64_t j) { return n - L - j; },
                    base + vc[i]);
      }
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nthreads; ++t) th.emplace_back(worker);
    worker();
    for (auto& t : th) t.join();
  }
  lap("fill");
  codes.clear();
  codes.shrink_to_fit();

  // ---- sort: partition by the key's top byte (a contiguous h1 range ---
  // each, so equal-h1 runs never cross buckets), then per-bucket
  // std::sort by (key, tie) — the numpy path's exact final order.
  std::vector<int64_t> hist(256, 0);
  {
    std::vector<std::vector<int64_t>> lh(static_cast<size_t>(nthreads),
                                         std::vector<int64_t>(256, 0));
    std::vector<std::thread> th;
    int64_t chunk = (M + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      th.emplace_back([&, t]() {
        int64_t a = t * chunk, b = std::min<int64_t>(M, a + chunk);
        auto& h = lh[size_t(t)];
        for (int64_t p = a; p < b; ++p) ++h[ent[size_t(p)].key >> 56];
      });
    }
    for (auto& t : th) t.join();
    for (int t = 0; t < nthreads; ++t)
      for (int b = 0; b < 256; ++b) hist[b] += lh[size_t(t)][b];
  }
  lap("hist");
  std::vector<int64_t> bstart(257);
  bstart[0] = 0;
  for (int b = 0; b < 256; ++b) bstart[b + 1] = bstart[b] + hist[b];

  std::vector<Entry> sorted(static_cast<size_t>(M));
  {
    // per-thread scatter cursors: thread t owns a contiguous input range
    // and a pre-computed per-bucket base inside each bucket
    int64_t chunk = (M + nthreads - 1) / nthreads;
    std::vector<std::vector<int64_t>> lh(static_cast<size_t>(nthreads),
                                         std::vector<int64_t>(256, 0));
    for (int t = 0; t < nthreads; ++t) {
      int64_t a = t * chunk, b = std::min<int64_t>(M, a + chunk);
      auto& h = lh[size_t(t)];
      for (int64_t p = a; p < b; ++p) ++h[ent[size_t(p)].key >> 56];
    }
    std::vector<std::vector<int64_t>> cur(static_cast<size_t>(nthreads),
                                          std::vector<int64_t>(256, 0));
    for (int b = 0; b < 256; ++b) {
      int64_t acc = bstart[b];
      for (int t = 0; t < nthreads; ++t) {
        cur[size_t(t)][b] = acc;
        acc += lh[size_t(t)][b];
      }
    }
    std::vector<std::thread> th;
    for (int t = 0; t < nthreads; ++t) {
      th.emplace_back([&, t]() {
        int64_t a = t * chunk, b = std::min<int64_t>(M, a + chunk);
        auto& c = cur[size_t(t)];
        for (int64_t p = a; p < b; ++p) {
          const Entry& e = ent[size_t(p)];
          sorted[size_t(c[e.key >> 56]++)] = e;
        }
      });
    }
    for (auto& t : th) t.join();
  }
  lap("scatter");
  ent.clear();
  ent.shrink_to_fit();

  std::vector<int64_t> bucket_max_dup(256, 0);
  {
    std::atomic<int> nextb(0);
    auto worker = [&]() {
      for (;;) {
        int b = nextb.fetch_add(1);
        if (b >= 256) return;
        int64_t a = bstart[b], e = bstart[b + 1];
        if (a == e) continue;
        Entry* p = sorted.data();
        std::sort(p + a, p + e, [](const Entry& x, const Entry& y) {
          return x.key != y.key ? x.key < y.key : x.tie < y.tie;
        });
        // longest equal-h1 run within the bucket + emit outputs
        int64_t best = 1, run = 1;
        uint32_t prev = uint32_t(p[a].key >> 32);
        for (int64_t q = a; q < e; ++q) {
          const Entry& x = p[q];
          uint32_t h1 = uint32_t(x.key >> 32);
          if (q > a) {
            run = (h1 == prev) ? run + 1 : 1;
            if (run > best) best = run;
          }
          prev = h1;
          h1o[q] = h1;
          h2o[q] = uint32_t(x.key);
          nodeo[q] = int32_t(uint32_t(x.tie >> 32));
          offo[q] = int32_t(uint32_t(x.tie));
        }
        bucket_max_dup[b] = best;
      }
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nthreads; ++t) th.emplace_back(worker);
    worker();
    for (auto& t : th) t.join();
  }
  lap("sort");
  int64_t max_dup = 0;
  for (int b = 0; b < 256; ++b)
    max_dup = std::max(max_dup, bucket_max_dup[b]);
  if (max_dup_out) *max_dup_out = max_dup;
  return M;
}
