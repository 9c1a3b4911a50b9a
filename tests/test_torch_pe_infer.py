"""The port's dense PE engine (`infer_pe_links(device="cpu")`) vs the JAX
package's engine and the pure-Python oracle, on the same numpy-seeded
graphs and reads. Link matrices are integer sums and the files are
bytes, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import (_make_batch, _random_refs, _sample_reads)
from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu_torch.core.fastq import ReadPairBatch
from vstrains_tpu_torch.ops import pe_infer as TP

torch.set_num_threads(1)


def _port_batch(batch):
    """The same reads as the port's ReadPairBatch type."""
    return ReadPairBatch(batch.fwd_codes, batch.fwd_len, batch.rve_codes,
                         batch.rve_len, batch.n_reads, batch.short_reads,
                         batch.used_reads)


def _port(ids, refs, batch, k, **kw):
    return TP.infer_pe_links(ids, refs, _port_batch(batch), k,
                             device="cpu", **kw)


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.node_mat, ref.node_mat)
    np.testing.assert_array_equal(res.short_mat, ref.short_mat)
    assert res.node_mat.dtype == np.int64
    assert (res.n_reads, res.short_reads, res.used_reads) == \
        (ref.n_reads, ref.short_reads, ref.used_reads)


@pytest.mark.parametrize("seed,k", [(0, 11), (1, 15), (2, 21)])
def test_matches_jax_and_oracle(seed, k):
    """The seeds and k of test_pe_infer.test_pe_matrices_match_oracle."""
    rng = np.random.RandomState(seed)
    n_nodes = 6
    lens = rng.randint(k + 5, 200, size=n_nodes)
    refs = _random_refs(rng, n_nodes, lens)
    refs[1] = refs[0][:40] + refs[1][40:] if len(refs[1]) > 40 else refs[1]
    fwd, rve = _sample_reads(rng, refs, 120, 40, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(n_nodes)]
    res = _port(ids, refs, batch, k, batch_size=32)
    _assert_same(res, JP.infer_pe_links(ids, refs, batch, k, batch_size=32))
    node_o, short_o, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(res.node_mat, node_o)
    np.testing.assert_array_equal(res.short_mat, short_o)


def test_batch_size_invariance():
    rng = np.random.RandomState(7)
    k = 13
    refs = _random_refs(rng, 4, [80, 90, 100, 110])
    fwd, rve = _sample_reads(rng, refs, 60, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(4)]
    base = JP.infer_pe_links(ids, refs, batch, k, batch_size=64)
    for bs in (7, 16, 64, 4096):
        _assert_same(_port(ids, refs, batch, k, batch_size=bs), base)


def test_iupac_reads_never_match():
    """Non-ACGT non-'N' read characters pass the loader but must never
    hash-match (the byte feed's bad-code invalidation)."""
    refs = ["ACGTACGTACGTACGTACGTACGT"]
    k = 7
    good = refs[0][:16]
    bad = good[:5] + "R" + good[6:]
    batch = _make_batch([bad, good], [bad, good], k + 1)
    res = _port(["x"], refs, batch, k, batch_size=4)
    _assert_same(res, JP.infer_pe_links(["x"], refs, batch, k,
                                        batch_size=4))
    node_o, short_o, *_ = oracle_pe_matrices(refs, [bad, good],
                                             [bad, good], k)
    np.testing.assert_array_equal(res.node_mat, node_o)
    np.testing.assert_array_equal(res.short_mat, short_o)
    assert res.node_mat.sum() > 0


def test_wire_and_byte_feeds_agree():
    """The same batch through the wire feed and the byte feed gives the
    same accumulators, and the driver's wire run equals a forced byte
    run."""
    rng = np.random.RandomState(13)
    k = 11
    refs = _random_refs(rng, 4, [90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 120, 32, k)
    batch = _port_batch(_make_batch(fwd, rve, k + 1))
    tab = TP._device_table(
        TP._card_table(TP.build_kmer_table(refs, k + 1), "cpu"), "sortfill")
    T = max(batch.fwd_codes.shape[1], batch.rve_codes.shape[1])
    accs = []
    for force_bytes in (False, True):
        acc = (torch.zeros((4, 4), dtype=torch.int64),
               torch.zeros((4, 4), dtype=torch.int64))
        kinds = []
        for kind, payload in TP._wire_batches(batch, 32,
                                              force_bytes=force_bytes):
            kinds.append(kind)
            feed = TP._upload_batch(kind, payload, "cpu")
            q1, h2, valid, lens = TP._batch_hashes(kind, feed, T,
                                                   tab.split_len)
            TP._batch_pairs(*TP._batch_stats(q1, h2, valid, tab), lens, tab,
                            *acc)
        assert set(kinds) == {"bytes" if force_bytes else "wire"}
        accs.append(acc)
    assert accs[0][0].sum() > 0
    for a, b in zip(*accs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ids = [str(i) for i in range(4)]
    _assert_same(TP.infer_pe_links(ids, refs, batch, k, batch_size=32,
                                   device="cpu"),
                 JP.infer_pe_links(ids, refs, _make_batch(fwd, rve, k + 1),
                                   k, batch_size=32))


def test_mixed_length_buckets_match_jax():
    """A mixed-length library takes the width-bucketed feed (1200 pairs
    at batch 128) and still equals the JAX engine exactly."""
    rng = np.random.RandomState(23)
    k = 11
    refs = _random_refs(rng, 6, [300, 350, 400, 300, 350, 400])
    short_f, short_r = _sample_reads(rng, refs, 900, 40, k)
    long_f, long_r = _sample_reads(rng, refs, 300, 120, k)
    batch = _make_batch(short_f + long_f, short_r + long_r, k + 1)
    assert TP._length_buckets(_port_batch(batch), k + 1, 128) is not None
    ids = [str(i) for i in range(len(refs))]
    _assert_same(_port(ids, refs, batch, k, batch_size=128),
                 JP.infer_pe_links(ids, refs, batch, k, batch_size=4096))


def _dup_graph(seed, n_motif, extra=0, motif_len=40, tail=60):
    rng = np.random.RandomState(seed)
    motif = _random_refs(rng, 1, [motif_len])[0]
    refs = [motif + _random_refs(rng, 1, [tail])[0]
            for _ in range(n_motif)]
    refs += _random_refs(rng, extra, [80 + 10 * i for i in range(extra)])
    return rng, refs


@pytest.mark.parametrize("stride", [1, 4, 8])
def test_probe_matches_jax_sortfill_strides(stride):
    """The searchsorted + payload-row probe equals the JAX sort + reverse
    cummin fill, slot for slot, at table strides 1, 4 and 8."""
    rng, refs = _dup_graph(17, 7, extra=5)
    k = 11
    table = JP.build_kmer_table(refs, k + 1)
    assert table.max_dup > 1
    nb = JP._sortfill_node_bits(len(refs))
    pays = JP._build_sortfill_payloads(table, nb)
    fwd, rve = _sample_reads(rng, refs, 100, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    codes = np.concatenate([batch.fwd_codes, batch.rve_codes])
    lens = np.concatenate([batch.fwd_len, batch.rve_len])
    want = np.asarray(JP._sortfill_node_slots(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(table.h1_biased), jnp.asarray(pays), k + 1, len(refs),
        node_bits=nb, stride=stride))
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    q1, h2, valid = ck.window_hashes_bytes(torch.from_numpy(codes),
                                           torch.from_numpy(lens), k + 1)
    got = TP._sortfill_probe(q1, h2, valid,
                             torch.from_numpy(table.h1_biased),
                             torch.from_numpy(pays), nb, len(refs))
    assert (want < len(refs)).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", ["1", "4", "8"])
def test_e2e_matches_jax_at_forced_stride(stride, monkeypatch):
    monkeypatch.setenv("VSTRAINS_SORTFILL_STRIDE", stride)
    rng, refs = _dup_graph(29, 3, extra=5, tail=120)
    k = 11
    fwd, rve = _sample_reads(rng, refs, 200, 40, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    _assert_same(_port(ids, refs, batch, k, batch_size=64),
                 JP.infer_pe_links(ids, refs, batch, k, batch_size=64))


def test_mid_n_wide_node_ids_match_jax_and_oracle():
    """540 nodes (10-bit node ids) with deep duplicate runs (max_dup in
    7..16)."""
    rng = np.random.RandomState(17)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    refs = ([motif + _random_refs(rng, 1, [40])[0] for _ in range(9)]
            + _random_refs(rng, 531, [60] * 531))
    table = TP.build_kmer_table(refs, k + 1)
    assert 6 < TP._card_table(table, "cpu").max_dup <= 16
    assert TP._sortfill_node_bits(540) == 10
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    res = _port(ids, refs, batch, k, batch_size=64, table=table)
    _assert_same(res, JP.infer_pe_links(ids, refs, batch, k, batch_size=64,
                                        stats_mode="dense"))
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(res.node_mat, nm)
    np.testing.assert_array_equal(res.short_mat, sm)


@pytest.mark.parametrize("native", ["1", "0"])
def test_kmer_table_and_payloads_match_jax(native, monkeypatch):
    monkeypatch.setenv("VSTRAINS_NATIVE_TABLE", native)
    _, refs = _dup_graph(5, 4, extra=3)
    a = TP._build_kmer_table(refs, 12)
    b = JP.build_kmer_table(refs, 12)
    for f in ("h1_biased", "h2", "node", "offset", "seq_lens"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.max_dup, a.num_nodes, a.num_entries) == \
        (b.max_dup, b.num_nodes, b.num_entries)
    np.testing.assert_array_equal(TP._build_sortfill_payloads(a, 9),
                                  JP._build_sortfill_payloads(b, 9))


def test_saturate_matches_jax():
    rng = np.random.RandomState(3)
    R, N, L = 64, 9, 12
    cnt = rng.randint(0, 40, (R, N)).astype(np.int32)
    cnt[rng.rand(R, N) < 0.4] = 0
    kmin = np.where(cnt > 0, rng.randint(0, 30, (R, N)),
                    2**31 - 1).astype(np.int32)
    lens = rng.randint(0, 60, R).astype(np.int32)
    seq_lens = rng.randint(L, 200, N).astype(np.int32)
    got = TP._saturate(torch.from_numpy(cnt), torch.from_numpy(kmin),
                       torch.from_numpy(lens), torch.from_numpy(seq_lens),
                       L)
    want = JP._saturate(jnp.asarray(cnt), jnp.asarray(kmin),
                        jnp.asarray(lens), jnp.asarray(seq_lens), L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) > 0)


def test_pe_files_and_stores_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    k = 13
    refs = _random_refs(rng, 5, [80, 95, 100, 120, 140])
    fwd, rve = _sample_reads(rng, refs, 100, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [f"n{i}" for i in range(5)]
    res = _port(ids, refs, batch, k, batch_size=32)
    ref = JP.infer_pe_links(ids, refs, batch, k, batch_size=32)
    for name, writer_t, writer_j in (
            ("full", TP.write_pe_files, JP.write_pe_files),
            ("sparse", TP.write_pe_files_sparse, JP.write_pe_files_sparse)):
        paths = {}
        for tag, writer, r in (("t", writer_t, res), ("j", writer_j, ref)):
            paths[tag] = (str(tmp_path / f"{name}_{tag}_pe"),
                          str(tmp_path / f"{name}_{tag}_st"))
            writer(r, *paths[tag])
        for a, b in zip(paths["t"], paths["j"]):
            assert open(a, "rb").read() == open(b, "rb").read()
    assert TP.pe_info_from_result(ids, res) == \
        JP.pe_info_from_result(ids, ref)
    sp_t, dc_t = TP.pe_info_sparse_from_result(ids, res)
    sp_j, dc_j = JP.pe_info_sparse_from_result(ids, ref)
    assert dict(sp_t) == dict(sp_j) and dict(dc_t) == dict(dc_j)
    pt = TP.process_pe_info(ids, *paths["t"])
    assert pt == JP.process_pe_info(ids, *paths["j"])


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.infer_pe_links(["a"], ["ACGT" * 10], None, 11, device="cuda")


def test_drain_dense_on_cpu_returns_the_accumulators():
    """The dense drain on CPU accumulators: int64 [N, N] host arrays,
    C-contiguous and writable, equal to what was accumulated."""
    gen = torch.Generator().manual_seed(3)
    accs = [torch.randint(0, 1000, (9, 9), dtype=torch.int64, generator=gen)
            for _ in range(2)]
    want = [a.clone() for a in accs]
    out = TP._drain_dense(*accs)
    assert len(out) == 2
    for got, ref in zip(out, want):
        assert isinstance(got, np.ndarray)
        assert got.dtype == np.int64 and got.shape == (9, 9)
        assert got.flags.c_contiguous and got.flags.writeable
        np.testing.assert_array_equal(got, ref.numpy())


def test_dense_drain_counts_no_pinned_bytes_on_cpu():
    """infer_pe_links(device="cpu") counts its 2·N²·8 result bytes and
    the device table build's two integers (16 bytes) as the engine's D2H,
    and none of them as page-locked."""
    from vstrains_tpu_torch.utils import tracing

    rng = np.random.RandomState(7)
    k = 13
    refs = _random_refs(rng, 5, [80, 90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 60, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    before = tracing.totals()
    res = _port([str(i) for i in range(5)], refs, batch, k, batch_size=16,
                stats_mode="dense")
    got = {key: v - before["counters"].get(key, 0)
           for key, v in tracing.totals()["counters"].items()}
    N = len(refs)
    assert got["pe.d2h_bytes"] == 2 * N * N * 8 + 16
    assert got.get("pe.d2h_pinned_bytes", 0) == 0
    assert "pe.d2h_pinned_bytes" not in tracing.since(before)
    assert f"pe.d2h_bytes {2 * N * N * 8 + 16}" in tracing.since(before)
    assert res.node_mat.flags.writeable and res.short_mat.flags.writeable
