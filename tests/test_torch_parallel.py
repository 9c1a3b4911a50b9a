"""The port's parallel layer (`vstrains_tpu_torch/parallel/`) on the CPU:
worlds of 2 and 4 gloo processes (tests/torch_dist_worker.py, rendezvous
through a file:// store in the test's temporary directory) against the
JAX package's sharded engines on the 8-device virtual CPU mesh at the same
(data, model) shape, and against its single-process engine and CLI.

Both worlds start once for the module and compute every case, each
rank writing its results to .npz files; the parametrized tests then
compare case by case (tolerance 0 throughout: every output is an
integer). Each sharded case also checks that every rank returned the
same result. At mesh 1 x 1 the same cases run in this process with no
world: the mesh's engines are the single-GPU engine's driver."""

import hashlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_pe_infer import _make_batch, _random_refs, _sample_reads
from tests.test_torch_pe_infer import _port_batch
from tests.torch_dist_worker import run_job
from tools.repeat_workload import repeat_workload
from vstrains_tpu.core.fastq import ReadPairBatch as JReadPairBatch
from vstrains_tpu.core.fastq import load_read_pairs as j_load_read_pairs
from vstrains_tpu.core.seq import encode_seq, window_hashes_np
from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu.parallel import mesh as JM
from vstrains_tpu_torch.evals.synth import (make_dataset,
                                            make_multi_component_dataset)
from vstrains_tpu_torch.ops import pe_infer as TP
from vstrains_tpu_torch.parallel import distributed as TD
from vstrains_tpu_torch.parallel import mesh as TM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_expected.json")) as _fh:
    METAVIRAL = json.load(_fh)["metaviral"]

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# case -> (inputs, engine, kwargs); "dup": duplicate runs within the
# packed probe (max_dup 6), "repeat": max_dup 20 > 16, the classic join
CASES = {
    "dense_sortfill": ("dup", "sharded", {}),
    "dense_classic": ("repeat", "sharded", {}),
    "sparse_sortfill": ("dup", "sparse_sharded", {}),
    "sparse_classic": ("repeat", "sparse_sharded", {}),
    "cap_retry": ("plain", "sparse_sharded", {"cap": 1, "cap_c": 2}),
    # link tables of 2 slots: restarts and rehashes, agreed over the world
    # (the port's own argument; the JAX engine has no tables)
    "table_growth": ("plain", "sparse_sharded", {"coo_slots": 2}),
    "auto_sparse": ("plain", "sharded", {"stats_mode": "sparse"}),
}
BATCH = 48
SYNTH_KW = dict(num_strains=2, num_bubbles=2, pairs_per_strain=150,
                seed=41)
SYNTH_K = 21


def _inputs(name):
    """(refs, fwd, rve, k) of a seeded input set."""
    if name == "repeat":
        return repeat_workload(n_groups=3, group_size=20, motif_len=30,
                               tail_len=50, n_pairs=240, read_len=40,
                               k=11, seed=7)
    k = 11
    if name == "dup":
        rng = np.random.RandomState(29)
        motif = _random_refs(rng, 1, [40])[0]
        refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(6)]
        fwd, rve = _sample_reads(rng, refs, 96, 30, k)
    elif name == "mixed":
        # two read widths, 300 pairs of 30 bp and 100 of 120 bp: the
        # dense engine's length buckets split them at batch BATCH
        rng = np.random.RandomState(53)
        refs = _random_refs(rng, 6, [200, 240, 280, 200, 240, 280])
        fwd, rve = _sample_reads(rng, refs, 300, 30, k)
        long_f, long_r = _sample_reads(rng, refs, 100, 120, k)
        fwd, rve = fwd + long_f, rve + long_r
    else:
        rng = np.random.RandomState(47)
        refs = _random_refs(rng, 6, [70, 90, 110, 130, 150, 170])
        fwd, rve = _sample_reads(rng, refs, 120, 35, k)
    return refs, fwd, rve, k


def _sp_inputs():
    rng = np.random.RandomState(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.randint(0, 4, 1000)].tobytes().decode()
    rng = np.random.RandomState(17)
    seqs = [bases[rng.randint(0, 4, n)].tobytes().decode()
            for n in (9000, 12000, 300)]  # two long, one short
    return seq, 22, seqs, 56


class _World:
    """One gloo world of `n` worker processes running a job list."""

    def __init__(self, base, n, jobs):
        self.base = base
        os.makedirs(base)
        jobs_path = os.path.join(base, "jobs.json")
        with open(jobs_path, "w") as fh:
            json.dump(jobs, fh)
        env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED="0")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, f"file://{base}/store", str(n), str(r),
             jobs_path], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=base) for r in range(n)]
        self.done = None

    def wait(self):
        if self.done is None:
            logs = [p.communicate(timeout=900)[0].decode(errors="replace")
                    for p in self.procs]
            self.done = (all(p.returncode == 0 for p in self.procs),
                         "\n".join(logs)[-6000:])
        assert self.done[0], self.done[1]

    def ranks(self, name):
        self.wait()
        return [np.load(os.path.join(self.base, f"{name}.r{r}.npz"))
                for r in range(len(self.procs))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    ins = {}
    for name in ("dup", "repeat", "plain", "mixed"):
        refs, fwd, rve, k = _inputs(name)
        b = _make_batch(fwd, rve, k + 1)
        ins[name] = str(base / f"{name}.npz")
        np.savez(ins[name], refs=np.array(refs), k=k, fc=b.fwd_codes,
                 fl=b.fwd_len, rc=b.rve_codes, rl=b.rve_len,
                 n_reads=b.n_reads, short_reads=b.short_reads)
    seq, L, seqs, table_L = _sp_inputs()
    np.savez(base / "sp.npz", seq=seq, L=L, seqs=np.array(seqs),
             table_L=table_L)
    synth = make_dataset(str(base / "synth"), **SYNTH_KW)
    meta = str(base / "metaviral")
    make_multi_component_dataset(meta, **METAVIRAL["generator"]["kwargs"])

    def sharded(shapes):
        return [_job(ins, case, d, m) for (d, m) in shapes
                for case in CASES]

    w2_jobs = sharded([(2, 1), (1, 2)]) + [
        dict(kind="sharded", inputs=ins["mixed"], data=2, model=1,
             batch_size=BATCH, out="mixed_2x1"),
        dict(kind="sp", inputs=str(base / "sp.npz"), out="sp"),
        dict(kind="multihost", data=os.path.dirname(synth.gfa_path),
             k=SYNTH_K, batch_size=256, out="multihost"),
        dict(kind="per_component", data=meta, batch_size=512,
             out=str(base / "w2" / "metaviral"))]
    return {2: _World(str(base / "w2"), 2, w2_jobs),
            4: _World(str(base / "w4"), 4, sharded([(2, 2)])),
            "synth": synth, "metaviral": meta, "inputs": ins}


def _job(ins, case, data, model):
    """The worker's job for one CASES entry at a (data, model) mesh."""
    inp, drv, kw = CASES[case]
    return dict(kind=drv, inputs=ins[inp], data=data, model=model,
                batch_size=BATCH, out=f"{case}_{data}x{model}", **kw)


def _mesh_ranks(worlds, case, data, model):
    """Every rank's result of a case: from the world of data x model
    ranks, or at 1 x 1 from this process with no world."""
    if data * model == 1:
        return [run_job(_job(worlds["inputs"], case, 1, 1), 0, 1)]
    return worlds[data * model].ranks(f"{case}_{data}x{model}")


def _j_reads(path):
    z = np.load(path)
    refs = [str(x) for x in z["refs"]]
    return ([str(i) for i in range(len(refs))], refs, int(z["k"]),
            JReadPairBatch(z["fc"], z["fl"], z["rc"], z["rl"],
                           int(z["n_reads"]), int(z["short_reads"]),
                           int(z["fl"].shape[0])))


_FIELDS = {"dense": ("node_mat", "short_mat"),
           "sparse": ("pair_keys", "pair_counts", "short_keys",
                      "short_counts")}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_jax_sharded(worlds, eight_devices, case, shape):
    """The port's sharded engine on a gloo world of data x model CPU ranks
    (at 1 x 1 in this process, with no world) equals JAX's
    infer_pe_links_sharded / infer_pe_links_sparse_sharded on the virtual
    mesh of the same shape, on every rank."""
    data, model = shape
    inp, drv, kw = CASES[case]
    ids, refs, k, reads = _j_reads(os.path.join(
        os.path.dirname(worlds[2].base), f"{inp}.npz"))
    mesh = JM.make_mesh(data=data, model=model, devices=eight_devices)
    fn = (JM.infer_pe_links_sharded if drv == "sharded"
          else JM.infer_pe_links_sparse_sharded)
    want = fn(ids, refs, reads, k, mesh, batch_size=BATCH,
              **{key: v for key, v in kw.items() if key != "coo_slots"})
    kind = ("sparse" if isinstance(want, JP.PESparseResult) else "dense")
    assert kind == ("dense" if case.startswith("dense") else "sparse")
    ranks = _mesh_ranks(worlds, case, data, model)
    assert len(ranks) == data * model
    for got in ranks:
        assert str(got["kind"]) == kind
        for f in _FIELDS[kind]:
            np.testing.assert_array_equal(got[f], getattr(want, f))
    total = (want.node_mat.sum() if kind == "dense"
             else want.pair_counts.sum())
    assert total > 0
    if case == "table_growth":
        # the ranks that count link keys (model rank 0) grew their tables
        assert all(int(got["coo_table_grows"]) > 0
                   for r, got in enumerate(ranks) if r % model == 0)


def test_sharded_cases_cover_both_probes():
    """The inputs reach both probe families: the packed probe (max_dup
    within 16, duplicates present) and the classic join (max_dup > 16)."""
    dup, rep = (TP._card_table(TP.build_kmer_table(_inputs(g)[0], 12), "cpu")
                for g in ("dup", "repeat"))
    assert 1 < dup.max_dup <= TP._SORTFILL_MAX_DUP < rep.max_dup
    assert TP._route_probe("sort", False, dup, TP._LOG) == "sortfill"
    assert TP._route_probe("sort", False, rep, TP._LOG) == "join"


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_mixed_lengths_equal_single_engine(worlds, shape):
    """A library of two read widths, which the dense engine's length
    buckets split, through the mesh (1 x 1 in this process, 2 x 1 over
    gloo): every rank's links equal infer_pe_links'."""
    data, model = shape
    path = worlds["inputs"]["mixed"]
    ids, refs, k, reads = _j_reads(path)
    reads = _port_batch(reads)
    assert TP._length_buckets(reads, k + 1, BATCH) is not None
    want = TP.infer_pe_links(ids, refs, reads, k, batch_size=BATCH,
                             device="cpu")
    if data * model == 1:
        ranks = [run_job(dict(kind="sharded", inputs=path, data=1, model=1,
                              batch_size=BATCH, out="mixed_1x1"), 0, 1)]
    else:
        ranks = worlds[2].ranks("mixed_2x1")
    assert want.node_mat.sum() > 0
    for got in ranks:
        assert str(got["kind"]) == "dense"
        for f in _FIELDS["dense"]:
            np.testing.assert_array_equal(got[f], getattr(want, f))


def test_sharded_small_input_past_the_cutover_equals_single_engine():
    """A batch past the dense/sparse cutover on an input of a few hundred
    pairs: infer_pe_links clamps the batch to the input and runs dense,
    and the mesh at 1 x 1 returns the same dense result, from the table
    it builds on its device."""
    from vstrains_tpu_torch.utils import tracing
    refs, fwd, rve, k = _inputs("plain")
    reads = _port_batch(_make_batch(fwd, rve, k + 1))
    ids = [str(i) for i in range(len(refs))]
    batch = 1 << 24
    assert batch > TP.dense_budget_rows(len(refs))
    want = TP.infer_pe_links(ids, refs, reads, k, batch_size=batch,
                             device="cpu")
    before = tracing.totals()["counters"]["pe.table_card_builds"]
    got = TM.infer_pe_links_sharded(ids, refs, reads, k,
                                    TM.make_mesh(device="cpu"),
                                    batch_size=batch)
    assert tracing.totals()["counters"]["pe.table_card_builds"] == before + 1
    assert isinstance(want, TP.PEResult) and isinstance(got, TP.PEResult)
    assert want.node_mat.sum() > 0
    for f in _FIELDS["dense"]:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_table_and_payloads_equal_jax(n_shards):
    """Sharding of the table built on the device: the shard arrays and the
    per-shard sortfill payloads equal the JAX package's, sentinels
    included."""
    refs = _inputs("dup")[0]
    t = TP._card_table(TP.build_kmer_table(refs, 12), "cpu")
    j = JP.build_kmer_table(refs, 12)
    a, b = TM.shard_table(t, n_shards), JM.shard_table(j, n_shards)
    for f in ("h1_biased", "h2", "node", "offset"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(
        TM.shard_sortfill_payloads(t, n_shards, 9),
        JM.shard_sortfill_payloads(j, n_shards, 9))


def _candidate_planes(rng, B2, R, N, kmax, miss):
    node = rng.randint(0, N, size=(B2, R)).astype(np.int32)
    kidx = rng.randint(0, kmax, size=(B2, R)).astype(np.int32)
    m = rng.rand(B2, R) < miss
    node[m] = TP._I32_MAX
    kidx[m] = TP._I32_MAX
    return node, kidx


@pytest.mark.parametrize("B2,R,N,kmax,cap_c,miss", [
    (16, 40, 7, 10, 8, 0.3),     # ragged: more candidates than cap_c
    (9, 12, 30, 12, 32, 0.5),    # padded: cap_c past the slot width
    (5, 64, 300, 64, 16, 0.9),   # sparse rows, many nodes
    (4, 24, 5, None, 8, 0.0),    # no kmax: the two-operand sort
])
def test_sparse_tp_helpers_equal_jax(B2, R, N, kmax, cap_c, miss):
    """_sparse_run_stats_compact on two table shards' planes, then
    _sparse_merge_sat_tail on the concatenated candidates, against the
    JAX functions on the same seeded inputs."""
    import jax
    import jax.numpy as jnp
    j_compact = jax.jit(JP._sparse_run_stats_compact,
                        static_argnums=(2, 3, 4))
    j_merge = jax.jit(JP._sparse_merge_sat_tail, static_argnums=(5, 6))
    rng = np.random.RandomState(B2 * 1000 + R)
    K = kmax or R
    lens = rng.randint(12, K + 12, size=B2).astype(np.int32)
    seq_lens = rng.randint(12, 200, size=N).astype(np.int32)
    t_parts, j_parts = [], []
    for _ in range(2):
        node, kidx = _candidate_planes(rng, B2, R, N, K, miss)
        t_out = TP._sparse_run_stats_compact(
            torch.from_numpy(node), torch.from_numpy(kidx), N, kmax, cap_c)
        j_out = j_compact(jnp.asarray(node), jnp.asarray(kidx), N, kmax,
                          cap_c)
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        t_parts.append(t_out[:3])
        j_parts.append(j_out[:3])
    t_cat = [torch.cat([p[i] for p in t_parts], 1) for i in range(3)]
    j_cat = [jnp.concatenate([p[i] for p in j_parts], 1) for i in range(3)]
    for cap in (2, 6):
        t = TP._sparse_merge_sat_tail(*t_cat, torch.from_numpy(lens),
                                      torch.from_numpy(seq_lens), 12, cap)
        j = j_merge(*j_cat, jnp.asarray(lens), jnp.asarray(seq_lens), 12,
                    cap)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sp_window_hashes_equal_jax_and_host(worlds, eight_devices):
    """Two data ranks hash a 1,000-code sequence in blocks of 500 (21
    windows cross the block edge): equal to the host hashes and to JAX's
    sp_window_hashes on a 2-device mesh."""
    seq, L, _, _ = _sp_inputs()
    codes = encode_seq(seq)
    e1, e2, ev = window_hashes_np(codes, L)
    j1, j2, jv = JM.sp_window_hashes(
        codes, L, JM.make_mesh(data=2, model=1, devices=eight_devices))
    for got in worlds[2].ranks("sp"):
        for a, b, c in ((got["h1"], e1, j1), (got["h2"], e2, j2),
                        (got["valid"], ev, jv)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, np.asarray(c))


def test_build_table_auto_sp_equals_host(worlds):
    """build_table_auto in a world of two ranks hashes the nodes of 8,192
    bp and more through the SP step: the table equals the host build (the
    port's and the JAX package's)."""
    _, _, seqs, L = _sp_inputs()
    host = TP._build_kmer_table(seqs, L)
    jhost = JP.build_kmer_table(seqs, L)
    for got in worlds[2].ranks("sp"):
        for f in ("h1", "h2", "node", "offset"):
            name = "h1_biased" if f == "h1" else f
            np.testing.assert_array_equal(got[f"tab_{f}"],
                                          getattr(host, name))
            np.testing.assert_array_equal(got[f"tab_{f}"],
                                          getattr(jhost, name))
        assert int(got["tab_max_dup"]) == host.max_dup == jhost.max_dup


def test_sp_block_hashes_rows_cut_at_the_row_width():
    """One block longer than many SP rows (each row its own halo) equals
    the host hashes, as on the card past the kernel's row limit."""
    rng = np.random.RandomState(9)
    codes = rng.randint(0, 5, size=3 * TM._SP_ROW_WINDOWS + 77).astype(
        np.uint8)
    L = 32
    h1, h2, valid = TM.sp_block_hashes(torch.from_numpy(codes), L)
    e1, e2, ev = window_hashes_np(codes, L)
    np.testing.assert_array_equal(h1.numpy().view(np.uint32), e1)
    np.testing.assert_array_equal(h2.numpy().view(np.uint32), e2)
    np.testing.assert_array_equal(valid.numpy(), ev)


def test_host_read_stripe_partition(tmp_path):
    fq1 = tmp_path / "r1.fq"
    fq2 = tmp_path / "r2.fq"
    with open(fq1, "w") as a, open(fq2, "w") as b:
        for i in range(10):
            a.write(f"@r{i}\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
            b.write(f"@r{i}\nTGCATGCATGCA\n+\nIIIIIIIIIIII\n")
    stripes = [TD.host_read_stripe(str(fq1), str(fq2), 6, pid, 3)
               for pid in range(3)]
    assert [s.num_pairs for s in stripes] == [4, 4, 2]
    whole = TD.host_read_stripe(str(fq1), str(fq2), 6, 0, 1)
    np.testing.assert_array_equal(
        np.concatenate([s.fwd_codes for s in stripes]), whole.fwd_codes)


def _synth_graph(ds):
    ids, seqs = [], []
    with open(ds.gfa_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                ids.append(f[1])
                seqs.append(f[2])
    return ids, seqs


@pytest.mark.parametrize("stats_mode", ["dense", "sparse"])
def test_multihost_two_ranks_equal_jax_serial(worlds, stats_mode):
    """Two processes, each with its stripe of the reads, through
    infer_pe_links_multihost and infer_pe_links_sparse_multihost: every
    rank's merged links equal the JAX package's single-process engine on
    all reads."""
    ds = worlds["synth"]
    ids, seqs = _synth_graph(ds)
    reads = j_load_read_pairs(ds.fwd_path, ds.rve_path, SYNTH_K + 1)
    want = JP.infer_pe_links(ids, seqs, reads, SYNTH_K, batch_size=256,
                             stats_mode=stats_mode)
    ranks = worlds[2].ranks("multihost")
    assert sum(int(r["stripe_pairs"]) for r in ranks) == reads.num_pairs
    for got in ranks:
        for f in _FIELDS[stats_mode]:
            np.testing.assert_array_equal(got[f], getattr(want, f))


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_per_component_two_ranks_equal_jax_record(worlds):
    """The port pipeline with --per-component on two ranks (components
    round-robin, strain dicts exchanged over gloo): each rank's outputs
    are byte-equal to the JAX package's single-process record."""
    for name, digest in METAVIRAL["inputs"].items():
        assert _sha(os.path.join(worlds["metaviral"], name)) == digest
    worlds[2].wait()
    for r in range(2):
        out = os.path.join(worlds[2].base, f"metaviral.r{r}")
        for name, digest in METAVIRAL["outputs"].items():
            assert _sha(os.path.join(out, name)) == digest, (r, name)
        with open(os.path.join(out, "vstrains.log")) as fh:
            log = fh.read()
        assert "per-component multihost: process %d/2" % r in log


def test_make_mesh_needs_a_world_past_one_rank():
    mesh = TM.make_mesh(device="cpu")
    assert (mesh.shape, mesh.backend) == ({"data": 1, "model": 1}, None)
    with pytest.raises(ValueError):
        TM.make_mesh(data=2, model=1, device="cpu")


@pytest.mark.parametrize("native", ["1", "0"])
def test_build_kmer_table_long_hash_equals_host(monkeypatch, native):
    """The host build with long nodes hashed by a callable (the SP step's
    contract) and the others by the host build, C++ or numpy: equal to
    the host table, and the callable sees each long node's two strands
    only."""
    _, _, seqs, L = _sp_inputs()
    want = TP._build_kmer_table(seqs, L)
    monkeypatch.setenv("VSTRAINS_NATIVE_TABLE", native)
    seen = []

    def hash_fn(codes):
        seen.append(codes.shape[0])
        return window_hashes_np(codes, L)

    got = TP._build_kmer_table(seqs, L, long_hash=(8192, hash_fn))
    assert sorted(seen) == [9000, 9000, 12000, 12000]
    for f in ("h1_biased", "h2", "node", "offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.max_dup, got.num_entries) == (want.max_dup,
                                              want.num_entries)


def test_pipeline_raises_when_the_sp_table_build_fails(monkeypatch,
                                                        tmp_path):
    """In a world of several ranks the pipeline builds the table on its
    own thread: a failure of the SP build (a collective or a kernel)
    ends the CLI run with that error, with no host rebuild."""
    from vstrains_tpu_torch import cli, pipeline

    def fail(*args, **kwargs):
        raise RuntimeError("SP build failed")

    def host_build(*args, **kwargs):
        raise AssertionError("the table was rebuilt on the host")

    ds = make_dataset(str(tmp_path / "data"), **SYNTH_KW)
    monkeypatch.setattr(pipeline, "world_size", lambda: 2)
    monkeypatch.setattr(pipeline, "build_table_auto", fail)
    monkeypatch.setattr(pipeline, "build_kmer_table", host_build)
    monkeypatch.setattr(TP, "build_kmer_table", host_build)
    try:
        with pytest.raises(RuntimeError, match="SP build failed"):
            cli.main(["-a", "spades", "-g", ds.gfa_path,
                      "-p", ds.paths_path, "-fwd", ds.fwd_path,
                      "-rve", ds.rve_path, "-o", str(tmp_path / "out"),
                      "--device", "cpu"])
    finally:  # the aborted run leaves its log handlers attached
        logger = logging.getLogger(f"vstrains-tpu-torch {cli.__version__}")
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
