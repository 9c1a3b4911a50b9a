"""The port's sparse PE engine vs the JAX package's, step by step and end
to end, on the same numpy-seeded inputs: the row-run stats (packed and
two-operand forms), the run compaction, the saturation tail (both
branches), the engine's COO arrays (also against the pure-Python
oracle), the cap-overflow retry, and the files and stores built from a
PESparseResult; then the link-key tables (`cuda_kernels.coo_accum`, its
plain version and a numpy emulation of its CUDA kernel, with the
driver's finish) against the host COO they replace. Everything is
integer, so every comparison is exact.

Order contract: jax.lax.sort is not stable and sort_rows orders by (key,
val). Each test compares exactly the slots the engine reads: all of
them where the sort key is a total order (the packed form), and the run
ends or the valid compacted columns elsewhere."""

import logging
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import _make_batch, _random_refs, _sample_reads
from tests.test_torch_pe_infer import _dup_graph, _port_batch
from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP

torch.set_num_threads(1)

_I32_MAX = 2**31 - 1


def _slots(rng, B2, K, D, N, miss=0.5):
    """Probe-shaped (node_key, kidx_v) planes [B2, K*D]: node ids in
    [0, N) with INT32_MAX misses, k-index = slot // D where matched."""
    R = K * D
    node = rng.randint(0, N, (B2, R)).astype(np.int32)
    # a few nodes per read, so runs are long
    node = np.where(rng.rand(B2, R) < 0.7, node[:, :1] + rng.randint(0, 3),
                    node) % N
    node = node.astype(np.int32)
    node[rng.rand(B2, R) < miss] = _I32_MAX
    kidx = np.where(node != _I32_MAX, (np.arange(R) // D)[None, :],
                    _I32_MAX).astype(np.int32)
    return node, kidx


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("form,N,kmax", [("packed", 9, 20),
                                         ("unpacked", 9, None),
                                         ("unpacked", 2**27, 20)])
def test_row_run_stats_matches_jax(form, N, kmax):
    """kmax=None, or node ids whose (N-1) << kbits reaches 2^31, take the
    two-operand sort with segmented scans."""
    rng = np.random.RandomState(N % 1000 + (kmax or 0))
    B2, K, D = 16, 20, 3
    node, kidx = _slots(rng, B2, K, D, N)
    kbits = max(1, int(K - 1).bit_length())
    assert (form == "packed") == (kmax is not None
                                  and ((N - 1) << kbits) < _I32_MAX)
    got = [x.numpy() for x in TP._row_run_stats(*_t(node, kidx), N, kmax)]
    want = [np.asarray(x) for x in
            JP._row_run_stats(*_j(node, kidx), N, kmax)]
    node_s, cnt, kmin, is_end = got
    np.testing.assert_array_equal(node_s, want[0])
    np.testing.assert_array_equal(cnt, want[1])
    np.testing.assert_array_equal(is_end, want[3])
    assert is_end.sum() > B2
    if form == "packed":
        np.testing.assert_array_equal(kmin, want[2])
    else:
        # the running min inside a run follows the sort's tie order; the
        # run-end value (what the tail reads) is the run's min either way
        np.testing.assert_array_equal(kmin[is_end], want[2][is_end])


@pytest.mark.parametrize("cap_c", [4, 32])
def test_sort_compact_runs_matches_jax(cap_c):
    rng = np.random.RandomState(cap_c)
    node, kidx = _slots(rng, 24, 16, 4, 40, miss=0.3)
    stats_t = TP._row_run_stats(*_t(node, kidx), 40, 16)
    stats_j = JP._row_run_stats(*_j(node, kidx), 40, 16)
    got = TP._sort_compact_runs(*stats_t, cap_c)
    want = JP._sort_compact_runs(*stats_j, cap_c)
    valid = got[0].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want[0]))
    assert valid.any() and (cap_c == 4 or not valid.all())
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(w)[valid])
    assert bool(got[4]) == bool(want[4]) == (cap_c == 4)


@pytest.mark.parametrize("K,D,cap,cap_c", [(16, 2, 16, 32),   # cap_c >= R
                                           (30, 3, 16, 32),
                                           (30, 3, 2, 32),    # cap overflow
                                           (30, 3, 16, 3)])   # cap_c overflow
def test_sparse_sat_tail_matches_jax(K, D, cap, cap_c):
    rng = np.random.RandomState(K * D + cap + cap_c)
    B2, N, L = 32, 12, 8
    node, kidx = _slots(rng, B2, K, D, N, miss=0.4)
    lens = rng.randint(L, K + L, B2).astype(np.int32)
    seq_lens = rng.randint(L, 3 * L, N).astype(np.int32)
    out, ovf, counts = TP._sparse_sat_tail(*_t(node, kidx, lens, seq_lens),
                                           L, cap, kmax=K, cap_c=cap_c)
    w_out, w_ovf, w_counts = JP._sparse_sat_tail(
        *_j(node, kidx, lens, seq_lens), L, cap, kmax=K, cap_c=cap_c)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(w_counts))
    assert bool(ovf) == bool(w_ovf)
    assert (out.numpy() >= 0).sum() > 0
    assert bool(ovf) == (cap == 2 or cap_c == 3)


def _coo_dense(keys, counts, n):
    out = np.zeros((n, n), np.int64)
    out[keys // n, keys % n] = counts
    return out


def _assert_same_coo(res, ref):
    assert isinstance(res, TP.PESparseResult)
    for f in ("pair_keys", "pair_counts", "short_keys", "short_counts"):
        got, want = getattr(res, f), getattr(ref, f)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert (res.n_reads, res.short_reads, res.used_reads) == \
        (ref.n_reads, ref.short_reads, ref.used_reads)


def _sparse(engine, ids, refs, batch, k, **kw):
    if engine is TP:
        return TP.infer_pe_links(ids, refs, _port_batch(batch), k,
                                 stats_mode="sparse", device="cpu", **kw)
    return JP.infer_pe_links(ids, refs, batch, k, stats_mode="sparse", **kw)


@pytest.mark.parametrize("stride", ["1", "4"])
def test_sparse_engine_matches_jax_and_oracle(stride, monkeypatch):
    """COO arrays equal to the JAX sparse engine's at its table strides 1
    and 4 (the port's probe has no stride), and to the oracle."""
    monkeypatch.setenv("VSTRAINS_SORTFILL_STRIDE", stride)
    rng, refs = _dup_graph(31, 5, extra=6, tail=100)
    k = 11
    fwd, rve = _sample_reads(rng, refs, 150, 40, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    assert TP._build_kmer_table(refs, k + 1).max_dup > 1
    res = _sparse(TP, ids, refs, batch, k, batch_size=32)
    _assert_same_coo(res, _sparse(JP, ids, refs, batch, k, batch_size=32))
    node_o, short_o, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    n = len(refs)
    np.testing.assert_array_equal(
        _coo_dense(res.pair_keys, res.pair_counts, n), node_o)
    np.testing.assert_array_equal(
        _coo_dense(res.short_keys, res.short_counts, n), short_o)
    assert res.pair_counts.sum() > 0


def test_sparse_byte_feed_matches_jax():
    """IUPAC codes inside reads send batches through the byte feed."""
    rng = np.random.RandomState(41)
    k = 13
    refs = _random_refs(rng, 6, [90, 100, 110, 120, 130, 140])
    fwd, rve = _sample_reads(rng, refs, 60, 35, k)
    fwd = [f[:7] + "R" + f[8:] if i % 3 == 0 else f
           for i, f in enumerate(fwd)]
    batch = _make_batch(fwd, rve, k + 1)
    kinds = {kind for kind, _ in TP._wire_batches(_port_batch(batch), 16)}
    assert "bytes" in kinds
    ids = [f"n{i}" for i in range(6)]
    _assert_same_coo(_sparse(TP, ids, refs, batch, k, batch_size=16),
                     _sparse(JP, ids, refs, batch, k, batch_size=16))


@pytest.mark.parametrize("n_nodes", [20, 40])
def test_cap_overflow_retry_matches_jax(n_nodes, caplog):
    """Every read saturates all n_nodes short nodes tiled along it: more
    than the starting cap of 16 (and, at 40, more distinct matches than
    cap_c = 32), so the run retries at 4x the caps. (The JAX package's
    own retry test uses 20 identical nodes, whose duplicate runs of 20
    need the classic join, which the port does not have.)"""
    rng = np.random.RandomState(n_nodes)
    k = 13
    seq = _random_refs(rng, 1, [n_nodes + 20])[0]
    refs = [seq[i:i + 16] for i in range(n_nodes)]
    read = seq[:n_nodes + 16]
    fwd = [read] * 8 + [seq[2:40]] * 4
    rve = [read] * 8 + [seq[:30]] * 4
    batch = _make_batch(fwd, rve, k + 1)
    assert TP._build_kmer_table(refs, k + 1).max_dup <= 16
    ids = [str(i) for i in range(n_nodes)]
    with caplog.at_level(logging.INFO):
        res = _sparse(TP, ids, refs, batch, k, batch_size=8)
    assert any("overflowed" in r.message and r.name == TP.__name__
               for r in caplog.records)
    _assert_same_coo(res, _sparse(JP, ids, refs, batch, k, batch_size=8))
    node_o, short_o, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(
        _coo_dense(res.pair_keys, res.pair_counts, n_nodes), node_o)
    np.testing.assert_array_equal(
        _coo_dense(res.short_keys, res.short_counts, n_nodes), short_o)
    assert node_o.min() >= 8


def test_files_and_stores_from_sparse_result_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    k = 13
    refs = _random_refs(rng, 7, [80, 95, 100, 120, 140, 150, 170])
    fwd, rve = _sample_reads(rng, refs, 120, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [f"n{i}" for i in range(7)]
    res = _sparse(TP, ids, refs, batch, k, batch_size=32)
    ref = _sparse(JP, ids, refs, batch, k, batch_size=32)
    dense = TP.infer_pe_links(ids, refs, _port_batch(batch), k,
                              batch_size=32, device="cpu")
    for name, writer_t, writer_j in (
            ("full", TP.write_pe_files, JP.write_pe_files),
            ("sparse", TP.write_pe_files_sparse, JP.write_pe_files_sparse)):
        got = [str(tmp_path / f"{name}_t_{f}") for f in ("pe", "st")]
        want = [str(tmp_path / f"{name}_j_{f}") for f in ("pe", "st")]
        from_dense = [str(tmp_path / f"{name}_d_{f}") for f in ("pe", "st")]
        writer_t(res, *got)
        writer_j(ref, *want)
        writer_t(dense, *from_dense)
        for a, b, c in zip(got, want, from_dense):
            data = open(a, "rb").read()
            assert data == open(b, "rb").read() == open(c, "rb").read()
            assert data
    keep = ids[1:]  # a node outside the store's node set is dropped
    for nodes in (ids, keep):
        sp_t, dc_t = TP.pe_info_sparse_from_result(nodes, res)
        sp_j, dc_j = JP.pe_info_sparse_from_result(nodes, ref)
        assert dict(sp_t) == dict(sp_j) and dict(dc_t) == dict(dc_j)
        sp_d, _ = TP.pe_info_sparse_from_result(nodes, dense)
        assert dict(sp_t) == dict(sp_d)
        assert len(dict(sp_t)) > 0


# --------------------------------------------------------------------------
# the link-key tables (csrc/coo_accum.cu) against the host COO
# --------------------------------------------------------------------------

with open(os.path.join(os.path.dirname(TP.__file__), os.pardir, "csrc",
                       "coo_accum.cu")) as _fh:
    _COO_CU = _fh.read()


def _cu_u64(name):
    return int(re.search(rf"{name} = (0x[0-9a-f]+)ull;", _COO_CU).group(1),
               16)


_HASH_MUL = _cu_u64("kHashMul")


def test_coo_kernel_constants_match_the_wrapper():
    assert _cu_u64("kEmpty") == ck.COO_EMPTY
    got = dict(re.findall(r"(k\w+) = (\d+)", re.search(
        r"constexpr int kOvf = [^;]+;", _COO_CU).group(0)))
    assert got == {"kOvf": str(ck.COO_OVF), "kKeys": str(ck.COO_KEYS),
                   "kFill": str(ck.COO_FILL), "kFullFlag": str(ck.COO_FULL)}
    assert ck.COO_STATS == ck.COO_FULL + 2


def _emu_insert(tab, key, cnt):
    """csrc/coo_accum.cu's insert(): 1 claimed, 0 found, -1 full."""
    S = tab.shape[0]
    s = ((key * _HASH_MUL) % 2**64) >> (64 - (S.bit_length() - 1))
    for _ in range(S):
        if tab[s, 0] == ck.COO_EMPTY:
            tab[s] = key, cnt
            return 1
        if tab[s, 0] == key:
            tab[s, 1] += cnt
            return 0
        s = (s + 1) & (S - 1)
    return -1


def _emu_walk(f, r, N):
    """One lane's (table, key) steps in the kernel's order: each row's
    ids up to its first -1; pair keys row by row, then the forward and
    the reverse same-end keys, i <= j."""
    f = [int(x) for x in f[:np.argmin(np.append(f, -1) >= 0)]]
    r = [int(x) for x in r[:np.argmin(np.append(r, -1) >= 0)]]
    steps = [(0, u * N + v) for u in f for v in r]
    for ids in (f, r):
        steps += [(1, ids[i] * N + ids[j]) for i in range(len(ids))
                  for j in range(i, len(ids))]
    return steps


def _emu_coo_accum(out, ovf, tables):
    """coo_accum_kernel in numpy: 32 lanes a warp, one read pair a lane;
    at each step the lanes holding one (table, key) add it once, by the
    group's size; the warp's keys and claims go to the counters."""
    stats = tables.stats
    stats[ck.COO_OVF] = int(ovf)
    if ovf:
        return
    B, N = out.shape[0] // 2, tables.num_nodes
    full = bool(stats[ck.COO_FULL:].any())
    tabs = [t.numpy() for t in tables.tabs]
    for w in range(0, max(B, 1), 32):
        walks = [_emu_walk(out[p], out[B + p], N) if p < B else []
                 for p in range(w, w + 32)]
        stats[ck.COO_KEYS] += sum(len(x) for x in walks)
        for step in range(0 if full else max(len(x) for x in walks)):
            groups = {}
            for walk in walks:
                if step < len(walk):
                    groups[walk[step]] = groups.get(walk[step], 0) + 1
            for (t, key), n in groups.items():
                got = _emu_insert(tabs[t], key, n)
                if got > 0:
                    stats[ck.COO_FILL + t] += 1
                elif got < 0:
                    stats[ck.COO_FULL + t] = 1


def _emu_grow(tables, t):
    """coo_rehash_kernel in numpy: every key into an empty 4x table."""
    new = ck._empty_table(4 * tables.slots[t], "cpu")
    for key, cnt in tables.tabs[t].numpy():
        if key != ck.COO_EMPTY:
            _emu_insert(new.numpy(), int(key), int(cnt))
    tables.tabs[t] = new
    tables.slots[t] *= 4


def _emu_accum(out, ovf, tables):
    _emu_coo_accum(out.numpy(), bool(ovf), tables)


def _coo_lists(rng, B, cap, N, fwd=True, rve=True, full=False):
    """A batch's (2B, cap) saturated lists as the sparse tail returns
    them: each row's ids distinct and ascending, then -1s; the ids drawn
    from a few nodes, so keys repeat across lanes."""
    out = np.full((2 * B, cap), -1, np.int32)
    pool = rng.choice(N, min(N, 3 * cap), replace=False)
    for row in range(2 * B):
        if not (fwd if row < B else rve):
            continue
        n = cap if full else rng.randint(0, cap + 1)
        out[row, :n] = np.sort(rng.choice(pool, n, replace=False))
    return out


def _host_coo(lists, N):
    """The host COO the tables replace: _sparse_pairs_np a batch,
    np.unique, then _merge_coo over the batches."""
    chunks = [[], [], [], []]
    for out in lists:
        B = out.shape[0] // 2
        for t, keys in enumerate(ck._sparse_pairs_np(out[:B], out[B:], N)):
            u, c = np.unique(keys, return_counts=True)
            chunks[2 * t].append(u)
            chunks[2 * t + 1].append(c)
    return (*ck._merge_coo(chunks[0], chunks[1]),
            *ck._merge_coo(chunks[2], chunks[3]))


def _expanded(lists, N):
    return sum(k.size for out in lists for k in ck._sparse_pairs_np(
        out[:out.shape[0] // 2], out[out.shape[0] // 2:], N))


COO_CASES = {
    "empty_rows": dict(fwd=False, rve=False),
    "rows_full_at_cap": dict(full=True),
    "forward_only": dict(rve=False),
    "reverse_only": dict(fwd=False),
    "batches_into_one_table": dict(batches=4),
    "batches_across_a_growth": dict(batches=4, grow_after=2, slots=512),
    "keys_past_2_32": dict(batches=2, N=70_000),
}


@pytest.mark.parametrize("route", ["plain", "kernel_emulated"])
@pytest.mark.parametrize("case", sorted(COO_CASES))
def test_coo_accum_matches_host_coo(case, route):
    """Each batch into the tables (the wrapper's plain version, or the
    kernel's emulation), then an overflowed batch (which adds nothing),
    then the driver's finish (pe_infer._coo_finish: keys sorted, cut to
    the filled slots): the host COO's arrays entry for entry, int64; the
    counters: the overflow flag, every expanded key, the distinct keys
    filled, no table full."""
    p = dict(batches=1, fwd=True, rve=True, full=False, N=50,
             grow_after=None, slots=4096)
    p.update(COO_CASES[case])
    rng = np.random.RandomState(len(case))
    B, cap, N = 40, 5, p["N"]
    lists = [_coo_lists(rng, B, cap, N, p["fwd"], p["rve"], p["full"])
             for _ in range(p["batches"])]
    tables = ck.CooTables(N, "cpu", slots=p["slots"])
    accum = ck.coo_accum if route == "plain" else _emu_accum
    grow = ck.CooTables.grow if route == "plain" else _emu_grow
    for i, out in enumerate(lists):
        accum(torch.from_numpy(out), torch.tensor(False), tables)
        if i + 1 == p["grow_after"]:
            assert 2 * tables.stats[ck.COO_FILL] > tables.slots[0]
            grow(tables, 0)
            grow(tables, 1)
    accum(torch.from_numpy(np.zeros((2 * B, cap), np.int32)),
          torch.tensor(True), tables)
    stats = tables.stats.tolist()
    want = _host_coo(lists, N)
    got = TP._coo_finish(tables, stats[ck.COO_FILL:ck.COO_FILL + 2])
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert stats == [1, _expanded(lists, N), want[0].size, want[2].size,
                     0, 0]
    if case == "empty_rows":
        assert stats[ck.COO_KEYS] == 0
    elif case in ("forward_only", "reverse_only"):
        assert want[0].size == 0 < want[2].size
    else:
        assert want[1].max() > 1  # keys repeat
    if case == "keys_past_2_32":
        assert want[0].max() > 2**32


@pytest.mark.parametrize("route", ["plain", "kernel_emulated"])
def test_coo_accum_full_table_stops_inserting(route):
    """Keys past a table's slots mark it full (its slots all filled);
    later batches only add to the key count: the driver restarts the
    pass."""
    rng = np.random.RandomState(3)
    N, B = 60, 40
    lists = [_coo_lists(rng, B, 5, N) for _ in range(2)]
    tables = ck.CooTables(N, "cpu", slots=16)
    accum = ck.coo_accum if route == "plain" else _emu_accum
    accum(torch.from_numpy(lists[0]), torch.tensor(False), tables)
    stats = tables.stats.tolist()
    assert stats[ck.COO_FILL:] == [16, 16, 1, 1]
    before = [t.clone() for t in tables.tabs]
    accum(torch.from_numpy(lists[1]), torch.tensor(False), tables)
    assert all(torch.equal(a, b) for a, b in zip(tables.tabs, before))
    assert tables.stats[ck.COO_KEYS] == _expanded(lists, N)


def test_coo_table_slots_follow_n():
    assert ck.coo_table_slots(8_700) == 2**20
    assert ck.coo_table_slots(1_000) == 2**16
    assert ck.coo_table_slots(9) == 256  # the first power of two past 2N²
    for n in (1, 9, 100, 1_000, 8_700, 300_000):
        s = ck.coo_table_slots(n)
        assert s & (s - 1) == 0 and (s > 2 * n * n or s >= 64 * n)
    with pytest.raises(ValueError):
        ck.CooTables(9, "cpu", slots=24)
