"""The port's classic probe (the sort join, the bucket lookup and the
searchsorted bound, each followed by the duplicate-run scan) vs the JAX
package's, on the same numpy-seeded graphs and reads: every probe mode in
both engines, the graphs that the packed probe cannot serve (duplicate
runs longer than 16, node ids beyond 2^18 — taken at small N by lowering
the limit in both packages), the table's bucket index, the lo planes and
the scan itself. Everything is integer, so every comparison is exact."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import _make_batch, _sample_reads
from tests.test_torch_pe_infer import _assert_same, _dup_graph, _port_batch
from tests.test_torch_pe_sparse import _assert_same_coo, _coo_dense
from tools.repeat_workload import repeat_workload
from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP

torch.set_num_threads(1)

_I32_MAX = 2**31 - 1


def _engines(ids, refs, batch, k, stats_mode, **kw):
    """(port result, JAX result) of one engine call with the same args."""
    got = TP.infer_pe_links(ids, refs, _port_batch(batch), k, device="cpu",
                            stats_mode=stats_mode, **kw)
    want = JP.infer_pe_links(ids, refs, batch, k, stats_mode=stats_mode, **kw)
    return got, want


def _assert_same_any(got, want):
    if isinstance(want, JP.PESparseResult):
        _assert_same_coo(got, want)
    else:
        assert isinstance(got, TP.PEResult)
        _assert_same(got, want)


def _assert_oracle(res, refs, fwd, rve, k):
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    n = len(refs)
    if isinstance(res, TP.PESparseResult):
        np.testing.assert_array_equal(
            _coo_dense(res.pair_keys, res.pair_counts, n), nm)
        np.testing.assert_array_equal(
            _coo_dense(res.short_keys, res.short_counts, n), sm)
    else:
        np.testing.assert_array_equal(res.node_mat, nm)
        np.testing.assert_array_equal(res.short_mat, sm)
    assert nm.sum() > 0


@pytest.mark.parametrize("stats_mode", ["dense", "sparse"])
@pytest.mark.parametrize("probe_mode", ["sortjoin", "lookup",
                                        "searchsorted"])
def test_probe_modes_match_jax(probe_mode, stats_mode, tmp_path):
    """Each classic probe mode in each engine: the matrices (or COO keys
    and counts) equal the JAX engine's with the same mode, and the
    written files are the same bytes."""
    rng, refs = _dup_graph(53, 5, extra=6, tail=100)
    k = 11
    assert 1 < TP._build_kmer_table(refs, k + 1).max_dup <= 16
    fwd, rve = _sample_reads(rng, refs, 150, 40, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [f"n{i}" for i in range(len(refs))]
    got, want = _engines(ids, refs, batch, k, stats_mode, batch_size=32,
                         probe_mode=probe_mode)
    _assert_same_any(got, want)
    paths = {}
    for tag, writer, res in (("t", TP.write_pe_files, got),
                             ("j", JP.write_pe_files, want)):
        paths[tag] = [str(tmp_path / f"{tag}_{f}") for f in ("pe", "st")]
        writer(res, *paths[tag])
    for a, b in zip(paths["t"], paths["j"]):
        data = open(a, "rb").read()
        assert data and data == open(b, "rb").read()


@pytest.mark.parametrize("stats_mode", ["auto", "sparse"])
def test_repeat_graph_takes_classic_join(stats_mode):
    """max_dup > 16 (24 nodes share a motif): "sort" takes the classic
    join in both engines, equal to the JAX engine and the oracle."""
    _, refs = _dup_graph(41, 24, motif_len=30, tail=50)
    k = 11
    assert TP._build_kmer_table(refs, k + 1).max_dup > TP._SORTFILL_MAX_DUP
    rng = np.random.RandomState(0)
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    got, want = _engines(ids, refs, batch, k, stats_mode, batch_size=64)
    assert isinstance(got, TP.PESparseResult) == (stats_mode == "sparse")
    _assert_same_any(got, want)
    _assert_oracle(got, refs, fwd, rve, k)


@pytest.mark.parametrize("stats_mode", ["auto", "sparse"])
def test_repeat64_graph_matches_jax(stats_mode):
    """A small repeat64 cell (tools/repeat_workload with groups of 64
    nodes: max_dup 64, so the sparse tail's rows of K x 64 = 95 x 64 slots
    pad to 8,192, past the 4,096 of the earlier network): 4 groups, 512
    pairs of 150 bp, k = 55, through both engines, equal to the JAX
    engines on the same inputs."""
    refs, fwd, rve, k = repeat_workload(n_groups=4, group_size=64,
                                        n_pairs=512)
    assert TP._build_kmer_table(refs, k + 1).max_dup == 64
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    got, want = _engines(ids, refs, batch, k, stats_mode, batch_size=256)
    assert isinstance(got, TP.PESparseResult) == (stats_mode == "sparse")
    _assert_same_any(got, want)
    nm = got.pair_counts if stats_mode == "sparse" else got.node_mat
    assert nm.sum() > 0


@pytest.mark.parametrize("stats_mode", ["dense", "sparse"])
def test_explicit_sortfill_beyond_packing(stats_mode, caplog):
    """An explicit "sortfill" on a graph beyond the packing: the dense
    engine warns and joins (the JAX warning), the sparse engine joins as
    it does for every explicit mode; both equal JAX and the oracle."""
    _, refs = _dup_graph(41, 24, motif_len=30, tail=50)
    k = 11
    rng = np.random.RandomState(1)
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    with caplog.at_level(logging.WARNING):
        got, want = _engines(ids, refs, batch, k, stats_mode, batch_size=64,
                             probe_mode="sortfill")
    warned = [r for r in caplog.records if r.name == TP.__name__
              and "using the classic sort join" in r.message]
    assert len(warned) == (stats_mode == "dense")
    _assert_same_any(got, want)
    _assert_oracle(got, refs, fwd, rve, k)


@pytest.mark.parametrize("stats_mode", ["auto", "sparse"])
def test_large_graph_route(stats_mode, monkeypatch):
    """Node ids beyond the packed probe's limit (2^18 there) route to the
    classic join; the limit is lowered to 2^8 in both packages so that
    this graph of 12 nodes is "large"."""
    monkeypatch.setattr(TP, "_SORTFILL_MAX_NODE_BITS", 8)
    monkeypatch.setattr(JP, "_SORTFILL_MAX_NODE_BITS", 8)
    rng, refs = _dup_graph(61, 4, extra=8, tail=90)
    k = 11
    table = TP._card_table(TP.build_kmer_table(refs, k + 1), "cpu")
    assert TP._sortfill_node_bits(len(refs)) is None
    assert TP._route_probe("sort", stats_mode == "sparse", table,
                           TP._LOG) == "join"
    fwd, rve = _sample_reads(rng, refs, 120, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    got, want = _engines(ids, refs, batch, k, stats_mode, batch_size=32)
    _assert_same_any(got, want)
    _assert_oracle(got, refs, fwd, rve, k)


# the JAX engine's batch functions, and the port probe each one means:
# the dense engine's fused batch names its probe in its `probe` argument
# ("sort" there is the classic join), its searchsorted mode runs
# _pe_batch_kernel (the join's left bound); the sparse engine runs the
# sortfill stats, the lookup or the join kernel
_JAX_DENSE_PROBE = {"sortfill": "sortfill", "sort": "join",
                    "lookup": "lookup"}
_JAX_SPIES = {"_pe_batch_fused": None, "_pe_batch_fused_wire": None,
              "_pe_batch_kernel": "join",
              "_stats_sparse_sortfill": "sortfill",
              "_stats_sparse_sortfill_wire": "sortfill",
              "_hash_lookup_kernel": "lookup", "_hash_join_kernel": "join"}


@pytest.mark.parametrize("probe_mode", TP._PROBE_MODES)
def test_routing_matches_jax_engine(probe_mode, monkeypatch):
    """The probe the port takes for a mode, in each engine, inside and
    beyond the packing (max_dup > 16), is the one the JAX engine takes
    there, read from which of its batch functions that engine calls."""
    seen = []

    def spy(name, probe):
        orig = getattr(JP, name)

        def wrapped(*a, **kw):
            seen.append(probe or _JAX_DENSE_PROBE[kw["probe"]])
            return orig(*a, **kw)
        monkeypatch.setattr(JP, name, wrapped)

    for name, probe in _JAX_SPIES.items():
        spy(name, probe)
    k = 11
    for seed, n_motif, kw in ((53, 5, dict(extra=2)),
                              (41, 24, dict(motif_len=30, tail=50))):
        rng, refs = _dup_graph(seed, n_motif, **kw)
        table = TP._card_table(TP.build_kmer_table(refs, k + 1), "cpu")
        fwd, rve = _sample_reads(rng, refs, 12, 30, k)
        batch = _make_batch(fwd, rve, k + 1)
        ids = [str(i) for i in range(len(refs))]
        for sparse in (False, True):
            seen.clear()
            JP.infer_pe_links(ids, refs, batch, k, batch_size=16,
                              probe_mode=probe_mode,
                              stats_mode="sparse" if sparse else "dense")
            want = TP._route_probe(probe_mode, sparse, table, TP._LOG)
            assert set(seen) == {want}, (table.max_dup, sparse)


def test_unknown_probe_mode_raises():
    with pytest.raises(ValueError, match="probe_mode"):
        TP.infer_pe_links(["a"], ["ACGT" * 10], None, 11, device="cpu",
                          probe_mode="sorted")


@pytest.mark.parametrize("graph", ["short_runs", "long_runs"])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("native", ["1", "0"])
def test_bucket_index_matches_jax(graph, pad, native, monkeypatch):
    """The bucket index that the lookup probe builds over a port table
    equals the fields of the JAX package's bucket_index=True table, from
    either table builder, padded or not: it covers the real entries only,
    so the padding inflates neither the starts nor the depth."""
    monkeypatch.setenv("VSTRAINS_NATIVE_TABLE", native)
    _, refs = (_dup_graph(5, 6, extra=4) if graph == "short_runs" else
               _dup_graph(41, 24, motif_len=30, tail=50))
    a = TP._build_kmer_table(refs, 12, pad_to_bucket=pad)
    b = JP.build_kmer_table(refs, 12, pad_to_bucket=pad, bucket_index=True)
    for f in ("h1_biased", "h2", "node", "offset", "seq_lens"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.max_dup, a.num_nodes, a.num_entries) == (
        b.max_dup, b.num_nodes, b.num_entries)
    starts, shift, depth = TP._bucket_index(a)
    assert starts.dtype == np.int32
    np.testing.assert_array_equal(starts, b.bucket_starts)
    assert (shift, depth) == (b.bucket_shift, b.scan_depth)
    assert starts[-1] == a.num_entries
    assert (a.num_entries < a.h1_biased.size) == pad


def _table_and_windows(seed=5, n_motif=6, n_pairs=60):
    """A padded table with duplicate runs and the stacked windows of
    reads sampled from it, hashed by the port (q1, h2, valid) — plus the
    byte codes for the JAX functions that hash for themselves."""
    rng, refs = _dup_graph(seed, n_motif, extra=4)
    k = 11
    table = JP.build_kmer_table(refs, k + 1, bucket_index=True)
    assert table.num_entries < table.h1_biased.size  # padded
    fwd, rve = _sample_reads(rng, refs, n_pairs, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    codes, lens = TP._stack_ends_np(batch.fwd_codes, batch.fwd_len,
                                    batch.rve_codes, batch.rve_len)
    q1, h2, valid = ck.window_hashes_bytes(torch.from_numpy(codes),
                                           torch.from_numpy(lens), k + 1)
    return table, k + 1, codes, lens, q1, h2, valid


def _edge_queries(table):
    """q1 values at the edges of the table: the smallest and largest
    int32, each real entry's h1 and its neighbours, the largest real h1
    plus one, and INT32_MAX (the padding's h1)."""
    real = table.h1_biased[:table.num_entries].astype(np.int64)
    q = np.concatenate([[-2**31, _I32_MAX, _I32_MAX - 1, real.max() + 1],
                        real[::7], real[::11] - 1, real[::13] + 1])
    q = np.clip(q, -2**31, _I32_MAX).astype(np.int32)
    return q.reshape(1, -1)


@pytest.mark.parametrize("probe", ["join", "lookup", "searchsorted"])
def test_lo_planes_match_jax(probe):
    """The lo plane of each classic probe against the JAX package's: the
    join's (_hash_join_impl on the byte codes, _join_from_q1 on queries at
    the table's edges and at the padding), the lookup's (_hash_lookup_impl,
    _lookup_from_q1) and the searchsorted probe's left bound; for that
    probe also the (count, min window) stats of _probe_stats, which masks
    by `idx < hi` where the scan tests h1 equality."""
    table, L, codes, lens, q1, h2, valid = _table_and_windows()
    tab_h1 = torch.from_numpy(table.h1_biased)
    jc, jl, jt = jnp.asarray(codes), jnp.asarray(lens), \
        jnp.asarray(table.h1_biased)
    edge = _edge_queries(table)
    if probe == "lookup":
        starts, shift, depth = TP._bucket_index(table)
        assert (shift, depth) == (table.bucket_shift, table.scan_depth)
        args = (torch.from_numpy(starts), tab_h1, shift, depth)
        got = TP._lookup_lo(q1, *args)
        *_, want = JP._hash_lookup_impl(
            jc, jl, jnp.asarray(table.bucket_starts), jt, L,
            table.bucket_shift, table.scan_depth)
        got_e = TP._lookup_lo(torch.from_numpy(edge), *args)
        want_e = JP._lookup_from_q1(jnp.asarray(edge),
                                    jnp.asarray(table.bucket_starts), jt,
                                    shift=table.bucket_shift,
                                    probe_depth=table.scan_depth)
        M = tab_h1.shape[0]
        assert (got_e.numpy() == M).any()  # queries the lookup misses
    else:
        got = TP._join_lo(q1, tab_h1)
        got_e = TP._join_lo(torch.from_numpy(edge), tab_h1)
        if probe == "join":
            *_, want = JP._hash_join_impl(jc, jl, jt, L)
            want_e = JP._join_from_q1(jnp.asarray(edge), jt)
        else:  # _probe_stats' bound
            want = jnp.searchsorted(jt, jnp.asarray(q1.numpy()).ravel(),
                                    side="left").reshape(q1.shape)
            want_e = jnp.searchsorted(jt, jnp.asarray(edge).ravel(),
                                      side="left").reshape(edge.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    # a query of the padding's h1 lands at the first padding entry
    if probe != "lookup":
        assert got_e.numpy()[0, 1] == table.num_entries
    if probe == "searchsorted":
        N = table.num_nodes
        cnt, kmin = ck.dup_stats_plain(
            q1, h2, valid, got,
            ck.table_record(tab_h1, torch.from_numpy(table.h2),
                            torch.from_numpy(table.node)),
            table.max_dup, N)
        wc, wk = JP._probe_stats(jc, jl, jt, jnp.asarray(table.h2),
                                 jnp.asarray(table.node), L, table.max_dup,
                                 N)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(kmin.numpy(), np.asarray(wk))
        assert cnt.numpy().sum() > 0


def _scan_case():
    """The windows of reads over a padded table with duplicate runs, their
    join bounds, and three more rows: queries equal to the padding (h1 =
    INT32_MAX, h2 = -1: they match the padding entries, node 0, up to the
    table's end), one whose scan starts 3 entries before the end, and an
    all-invalid row. Returns the table, (q1, h2, valid, lo), the table
    arrays and the same as JAX arrays."""
    table, _, _, _, q1, h2, valid = _table_and_windows(7, 9)
    M = table.h1_biased.size
    tab = tuple(torch.from_numpy(a) for a in (table.h1_biased, table.h2,
                                              table.node))
    lo = TP._join_lo(q1, tab[0])
    K = q1.shape[1]
    pad_q = torch.full((3, K), _I32_MAX, dtype=torch.int32)
    pad_h2 = torch.full((3, K), -1, dtype=torch.int32)
    pad_valid = torch.ones((3, K), dtype=torch.bool)
    pad_valid[2] = False
    pad_lo = torch.full((3, K), table.num_entries, dtype=torch.int32)
    pad_lo[1] = M - 3
    win = tuple(torch.cat([a, b]) for a, b in
                ((q1, pad_q), (h2, pad_h2), (valid, pad_valid),
                 (lo, pad_lo)))
    j = [jnp.asarray(x.numpy()) for x in win + tab]
    return table, win, tab, j


@pytest.mark.parametrize("depth", [1, 16, 17, 40])
def test_dup_stats_plain_matches_jax(depth):
    """dup_stats_plain (the dense engine's classic probe) against
    _dup_scan_stats_impl, with the table as the interleaved record, at
    depths below, at and past the packed probe's 16 ranks, on the reads'
    windows and the padding, M - 3 and invalid rows."""
    table, win, tab, j = _scan_case()
    M, N = table.h1_biased.size, table.num_nodes
    K = win[0].shape[1]
    wc, wk = (np.asarray(x) for x in JP._dup_scan_stats_impl(*j, depth, N))
    cnt, kmin = ck.dup_stats_plain(*win, ck.table_record(*tab), depth, N)
    assert cnt.dtype == kmin.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), wc)
    np.testing.assert_array_equal(kmin.numpy(), wk)
    c = cnt.numpy()
    # padding hits (node 0) end at the table's end; the invalid row misses
    assert c[-3, 0] == K * min(depth, M - table.num_entries)
    assert c[-2, 0] == K * min(depth, 3)
    assert (c[-1] == 0).all() and (kmin.numpy()[-1] == _I32_MAX).all()
    assert c[:-3].sum() > 0


@pytest.mark.parametrize("depth", [1, 16, 17, 40])
def test_dup_scan_plain_matches_jax(depth):
    """dup_scan_plain (the sparse engine's classic probe) against
    _sparse_expand_matches, the same depths and rows as above."""
    table, win, tab, j = _scan_case()
    M = table.h1_biased.size
    K = win[0].shape[1]
    want = [np.asarray(x) for x in JP._sparse_expand_matches(*j, depth)]
    got = ck.dup_scan_plain(*win, ck.table_record(*tab), depth)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (win[0].shape[0],
                                                      K * depth)
        np.testing.assert_array_equal(g.numpy(), w)
    g = got[0].numpy()
    assert (g[-3] == 0).sum() == K * min(depth, M - table.num_entries)
    assert (g[-2] == 0).sum() == K * min(depth, 3)
    assert (g[-1] == _I32_MAX).all()
    assert (g[:-3] != _I32_MAX).sum() > 0
    # the window index stands beside each match, the sentinel elsewhere
    kidx = np.arange(K * depth) // depth
    np.testing.assert_array_equal(
        got[1].numpy(), np.where(g != _I32_MAX, kidx[None, :], _I32_MAX))
