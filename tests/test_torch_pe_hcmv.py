"""The port's PE engine on a cut of the benchmark's `hcmv3` deployment
(three HCMV-like strains at the configuration's branch rates, abundances
and read profile, on a 30,000 bp genome at 40x), held entry for entry to
the benchmark's plain PyTorch reference (`portbench/reference/pe_links.py`:
exact k-mers, no hash, no kernel) on both of the engine's routes, and the
sparse engine's counters: `pe.coo_keys`, the link keys it expands,
`pe.sparse_retries`, its cap-overflow retries, `pe.coo_table_grows`, the
growths of its link tables (a rehash at half full, a restart of the pass
when full), and `pe.coo_unique_keys`."""

import logging

import numpy as np
import pytest
import torch

from portbench import data
from portbench.gen import hivsim
from portbench.reference import pe_links
from vstrains_tpu_torch.core.fastq import load_read_pairs
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP
from vstrains_tpu_torch.utils import tracing

torch.set_num_threads(1)

# hcmv3's recipe (portbench/configs/hcmv3.json) with the genome and the
# depth cut: ~1,000 nodes, 2,400 pairs
CUT = dict(shape="zikv15", n_strains=3, genome_len=30000, coverage=40.0,
           branch_rate=(0.003, 0.008), abundances=(50.0, 30.0, 20.0),
           km=56, read_len=250, phase_limit=250, max_contig_len=2500,
           sub_rate=0.003, indel_rate=0.0001, n_rate=0.0005)
BATCH = 1024


@pytest.fixture(scope="module")
def hcmv_cut(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hcmv_cut"))
    ds = hivsim.make_benchmark_dataset(out, seed=7, **CUT)
    ids, seqs, k = data.read_gfa(ds.gfa_path)
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, k + 1,
                            pad_to_multiple=32)
    ref = pe_links.pe_links(seqs, pe_links.load_reads(
        ds.fwd_path, ds.rve_path, k + 1), k, "cpu")
    assert len(ids) > 900 and reads.num_pairs > 1500
    assert ref.node_mat.sum() > 0 and ref.short_mat.sum() > 0
    return ids, seqs, reads, k, ref


def _dense(res, N):
    """A result's two link matrices, a COO result scattered."""
    if isinstance(res, TP.PEResult):
        return res.node_mat, res.short_mat
    out = []
    for keys, counts in ((res.pair_keys, res.pair_counts),
                         (res.short_keys, res.short_counts)):
        assert np.all(np.diff(keys) > 0)
        flat = np.zeros(N * N, np.int64)
        flat[keys] = counts
        out.append(flat.reshape(N, N))
    return out


@pytest.mark.parametrize("route", ["dense", "sparse", "sparse_by_budget"])
def test_hcmv_cut_links_equal_reference(hcmv_cut, route, monkeypatch):
    """dense: the batch below `dense_budget_rows(N)`; sparse: the sparse
    engine asked for; sparse_by_budget: the memory rule's own choice
    with the budget below the batch, as at the full size (N ~8,700,
    budget ~7,200 against the batch of 16,384)."""
    ids, seqs, reads, k, ref = hcmv_cut
    N = len(ids)
    assert BATCH < TP.dense_budget_rows(N)
    mode = "sparse" if route == "sparse" else "auto"
    if route == "sparse_by_budget":
        monkeypatch.setattr(TP, "dense_budget_rows", lambda n: BATCH // 2)
    res = TP.infer_pe_links(ids, seqs, reads, k, batch_size=BATCH,
                            stats_mode=mode, device="cpu")
    want = TP.PEResult if route == "dense" else TP.PESparseResult
    assert type(res) is want
    node, short = _dense(res, N)
    np.testing.assert_array_equal(node, ref.node_mat.numpy())
    np.testing.assert_array_equal(short, ref.short_mat.numpy())


def test_hcmv_coo_keys_counts_the_expanded_keys(hcmv_cut, monkeypatch):
    ids, seqs, reads, k, _ = hcmv_cut
    expanded = []
    pairs_np = ck._sparse_pairs_np

    def spy(f_nodes, r_nodes, n):
        pe, st = pairs_np(f_nodes, r_nodes, n)
        expanded.append(pe.size + st.size)
        return pe, st

    monkeypatch.setattr(ck, "_sparse_pairs_np", spy)
    before = tracing.totals()["counters"]
    TP.infer_pe_links(ids, seqs, reads, k, batch_size=BATCH,
                      stats_mode="sparse", device="cpu")
    got = tracing.totals()["counters"]
    assert len(expanded) == -(-reads.num_pairs // BATCH)
    assert (got["pe.coo_keys"] - before.get("pe.coo_keys", 0)
            == sum(expanded) > 0)
    assert (got["pe.sparse_retries"]
            == before.get("pe.sparse_retries", 0))


def test_hcmv_sparse_retries_counts_each_cap_overflow(hcmv_cut, caplog):
    """At cap 1 the reads that saturate two nodes overflow; each retry
    (caps x4) adds one, and the retried pass still equals the
    reference."""
    ids, seqs, reads, k, ref = hcmv_cut
    table = TP._card_table(TP.build_kmer_table(seqs, k + 1),
                           torch.device("cpu"))
    logger = logging.getLogger(TP.__name__)
    tab = TP._device_table(table, TP._route_probe("sort", True, table,
                                                  logger))
    before = tracing.totals()["counters"].get("pe.sparse_retries", 0)
    with caplog.at_level(logging.INFO, logger=TP.__name__):
        res = TP._infer_pe_links_sparse(ids, tab, reads, BATCH,
                                        logger, cap=1, cap_c=2)
    retries = tracing.totals()["counters"]["pe.sparse_retries"] - before
    said = sum("overflowed" in r.getMessage() for r in caplog.records)
    assert retries == said >= 1
    node, short = _dense(res, len(ids))
    np.testing.assert_array_equal(node, ref.node_mat.numpy())
    np.testing.assert_array_equal(short, ref.short_mat.numpy())


def test_sparse_counters_in_the_stage_line(hcmv_cut, monkeypatch):
    """The PE stage's line (`tracing.since`) of a process's first sparse
    pass names both counters beside `pe.d2h_bytes`, the retries at 0."""
    ids, seqs, reads, k, _ = hcmv_cut
    monkeypatch.setattr(tracing, "_COUNTS", {})  # a fresh process's
    before = tracing.totals()
    TP.infer_pe_links(ids, seqs, reads, k, batch_size=BATCH,
                      stats_mode="sparse", device="cpu")
    line = tracing.since(before)
    assert "pe.sparse_retries 0" in line and "pe.coo_table_grows 0" in line
    assert "pe.coo_keys " in line and "pe.d2h_bytes " in line
    assert "pe.coo_unique_keys " in line


class _Said(logging.Handler):
    """Records the engine's log messages and the tables' rehashes, in
    order."""

    def __init__(self, monkeypatch):
        super().__init__(logging.INFO)
        self.events = []
        grow = ck.CooTables.grow

        def spy(tables, t):
            self.events.append(f"rehash {t}")
            grow(tables, t)

        monkeypatch.setattr(ck.CooTables, "grow", spy)

    def emit(self, record):
        self.events.append(record.getMessage())

    def count(self, text):
        return sum(text in e for e in self.events)


def _sparse_engine(cut, said, batch, **kw):
    """The sparse engine on the cut, its log into `said`; returns the
    result and what `pe.coo_table_grows` and `pe.sparse_retries`
    gained."""
    ids, seqs, reads, k, _ = cut
    table = TP._card_table(TP.build_kmer_table(seqs, k + 1),
                           torch.device("cpu"))
    logger = logging.getLogger(f"{TP.__name__}.test_hcmv")
    logger.setLevel(logging.INFO)
    logger.addHandler(said)
    tab = TP._device_table(table, TP._route_probe("sort", True, table,
                                                  logger))
    names = ("pe.coo_table_grows", "pe.sparse_retries")
    before = tracing.totals()["counters"]
    try:
        res = TP._infer_pe_links_sparse(ids, tab, reads, batch,
                                        logger, **kw)
    finally:
        logger.removeHandler(said)
    got = tracing.totals()["counters"]
    return res, [got[n] - before.get(n, 0) for n in names]


def test_hcmv_link_tables_grow_and_restart(hcmv_cut, monkeypatch):
    """From tables of 1,024 slots (the cut needs ~7,600 pair and ~5,200
    short ones): a batch that fills a table restarts the pass with that
    table 4x larger, and a table whose filled slots the host reads past
    half is rehashed 4x before the next batch. Both engage and count in
    `pe.coo_table_grows`; the result equals the reference."""
    ids, ref = hcmv_cut[0], hcmv_cut[-1]
    said = _Said(monkeypatch)
    res, (grows, retries) = _sparse_engine(hcmv_cut, said, BATCH,
                                           coo_slots=1024)
    restarts = said.count("link table full")
    rehashes = said.count("rehash ")
    assert restarts >= 1 and rehashes >= 1 and retries == 0
    assert grows >= restarts + rehashes
    node, short = _dense(res, len(ids))
    np.testing.assert_array_equal(node, ref.node_mat.numpy())
    np.testing.assert_array_equal(short, ref.short_mat.numpy())


def test_hcmv_cap_retry_after_a_growth(hcmv_cut, monkeypatch):
    """At batch 256 and cap 9 the cut's first two batches fit and the
    third overflows (a read end saturates 10 nodes); from 4,096 slots the
    second batch takes both tables past half, so they are rehashed before
    the overflow. The retry (caps 36/72) starts from empty tables of the
    grown size and still equals the reference."""
    ids, ref = hcmv_cut[0], hcmv_cut[-1]
    said = _Said(monkeypatch)
    res, (grows, retries) = _sparse_engine(hcmv_cut, said, 256, cap=9,
                                           cap_c=18, coo_slots=4096)
    first_ovf = next(i for i, e in enumerate(said.events)
                     if "overflowed" in e)
    assert retries == 1 and said.count("rehash ") == grows >= 1
    assert said.events.index("rehash 0") < first_ovf
    assert said.count("link table full") == 0
    node, short = _dense(res, len(ids))
    np.testing.assert_array_equal(node, ref.node_mat.numpy())
    np.testing.assert_array_equal(short, ref.short_mat.numpy())
