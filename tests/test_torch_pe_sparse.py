"""The port's sparse PE engine vs the JAX package's, step by step and end
to end, on the same numpy-seeded inputs: the row-run stats (packed and
two-operand forms), the run compaction, the saturation tail (both
branches), the engine's COO arrays (also against the pure-Python
oracle), the cap-overflow retry, and the files and stores built from a
PESparseResult. Everything is integer, so every comparison is exact.

Order contract: jax.lax.sort is not stable and sort_rows orders by (key,
val). Each test compares exactly the slots the engine reads: all of
them where the sort key is a total order (the packed form), and the run
ends or the valid compacted columns elsewhere."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import _make_batch, _random_refs, _sample_reads
from tests.test_torch_pe_infer import _dup_graph, _port_batch
from vstrains_tpu.ops import pe_infer as JP
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
    assert TP.build_kmer_table(refs, k + 1).max_dup > 1
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
    assert TP.build_kmer_table(refs, k + 1).max_dup <= 16
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
