"""The port's copies of the JAX package's framework-free eval tools
(`vstrains_tpu_torch/evals/{paf_interop,quast,sampling,spades_wrapper,
graphviz}`), run as tests/test_paf_interop.py and tests/test_quast_exec.py
run the originals: the PAF paths against the port's own PE engine on the
CPU (and against the JAX package's), the MetaQUAST and SPAdes wrappers
against stand-in executables that check the command line they are given
(this machine has neither tool), the down-sampler and the DOT writer
against the originals' outputs."""

import os
import stat
import subprocess

import numpy as np
import pytest
import torch

from tests.oracle_pe import build_table
from tests.test_paf_interop import _aligner_path, _write_synthetic_paf
from tests.test_pe_infer import _random_refs, _sample_reads
from vstrains_tpu.evals import paf_interop as j_paf
from vstrains_tpu.evals import sampling as j_sampling
from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
from vstrains_tpu_torch.evals import graphviz, paf_interop, quast, sampling
from vstrains_tpu_torch.evals import spades_wrapper
from vstrains_tpu_torch.ops.pe_infer import infer_pe_links

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_QUAST = os.path.join(REPO, "tools", "fake_metaquast")


def _batch(fwd, rve):
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    return ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fl))


def _pairs(rng, refs, n, read_len, k):
    fwd, rve = _sample_reads(rng, refs, n, read_len, k)
    return [(f, r) for f, r in zip(fwd, rve)
            if "N" not in f and "N" not in r
            and len(f) >= k + 1 and len(r) >= k + 1]


def test_paf_matrices_match_port_engine(tmp_path):
    rng = np.random.RandomState(11)
    k = 11
    split_len = k + 1
    refs = _random_refs(rng, 5, [60, 80, 100, 120, 140])
    pairs = _pairs(rng, refs, 50, 30, k)
    ids = [str(i) for i in range(5)]
    read_ids = paf_interop.export_subread_fastq(
        pairs, str(tmp_path / "f.fq"), str(tmp_path / "r.fq"), split_len)
    assert read_ids == j_paf.export_subread_fastq(
        pairs, str(tmp_path / "jf.fq"), str(tmp_path / "jr.fq"), split_len)
    for name in ("f.fq", "r.fq"):
        with open(tmp_path / name, "rb") as a, \
                open(tmp_path / f"j{name}", "rb") as b:
            assert a.read() == b.read()
    table = build_table(refs, split_len)
    _write_synthetic_paf(tmp_path / "f.paf", [p[0] for p in pairs], table,
                         ids, split_len)
    _write_synthetic_paf(tmp_path / "r.paf", [p[1] for p in pairs], table,
                         ids, split_len)
    args = (ids, [len(s) for s in refs], read_ids, str(tmp_path / "f.paf"),
            str(tmp_path / "r.paf"), split_len)
    nm, sm = paf_interop.pe_matrices_from_paf(*args)
    jnm, jsm = j_paf.pe_matrices_from_paf(*args)
    np.testing.assert_array_equal(nm, jnm)
    np.testing.assert_array_equal(sm, jsm)
    res = infer_pe_links(ids, refs, _batch([p[0] for p in pairs],
                                           [p[1] for p in pairs]),
                         k, batch_size=32, device="cpu")
    np.testing.assert_array_equal(nm, res.node_mat)
    np.testing.assert_array_equal(sm, res.short_mat)


def test_legacy_alignment_matches_port_engine(tmp_path, monkeypatch):
    """The legacy aligner path end to end (a real minimap2 when one is on
    PATH, else the exact-match PAF emitter tools/fake_minimap2) against
    the port's hash engine on the CPU."""
    monkeypatch.setenv("PATH", _aligner_path(tmp_path))
    rng = np.random.RandomState(3)
    k = 27
    refs = _random_refs(rng, 4, [400, 500, 600, 700])
    pairs = _pairs(rng, refs, 50, 80, k)
    ids = [str(i) for i in range(4)]
    node_mat, short_mat = paf_interop.run_legacy_alignment(
        ids, refs, pairs, k, str(tmp_path))
    res = infer_pe_links(ids, refs, _batch([p[0] for p in pairs],
                                           [p[1] for p in pairs]),
                         k, batch_size=32, device="cpu")
    np.testing.assert_array_equal(node_mat, res.node_mat)
    np.testing.assert_array_equal(short_mat, res.short_mat)


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n{seq}\n")
    return str(path)


@pytest.fixture
def quast_inputs(tmp_path):
    truth = _write_fasta(tmp_path / "truth.fasta",
                         [("strainA.1 extra words", "ACGT" * 50),
                          ("strainB", "TTGG" * 50)])
    cand1 = _write_fasta(tmp_path / "ours.fasta",
                         [("A1", "ACGT" * 30), ("A2", "TTGG" * 30)])
    cand2 = _write_fasta(tmp_path / "theirs.fasta",
                         [("B1", "ACGT" * 25)])
    return truth, cand1, cand2


def test_quast_eval_runs_fixture(quast_inputs, tmp_path, monkeypatch):
    """The wrapper's MetaQUAST command (the fixture exits 2 on any flag
    the contract lacks), its per-strain reference split and cleanup."""
    truth, cand1, cand2 = quast_inputs
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "quast_out"
    quast.quast_eval([cand1, cand2], truth, str(out), FAKE_QUAST, run_id=3)
    header = (out / "combined_reference" / "report.tsv").read_text(
    ).splitlines()[0].split("\t")
    assert header == ["Assembly", "ours", "theirs"]
    assert sorted(os.listdir(out / "runs_per_reference")) == [
        "sub_3_strainA_ref", "sub_3_strainB_ref"]
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith("sub_3_") and p.endswith("_ref.fasta")]


def test_quast_cli_modes(quast_inputs, tmp_path, monkeypatch):
    truth, _, _ = quast_inputs
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "cli_out"
    assert quast.main(["-quast", FAKE_QUAST, "-d", str(tmp_path),
                       "-ref", truth, "-o", str(out)]) == 0
    header = (out / "combined_reference" / "report.tsv").read_text(
    ).splitlines()[0].split("\t")
    assert header == ["Assembly", "ours", "theirs", "truth"]
    assert quast.main(["-quast", FAKE_QUAST, "-ref", truth,
                       "-o", str(tmp_path / "x")]) == 1


def test_quast_eval_cleans_refs_on_failure(quast_inputs, tmp_path,
                                           monkeypatch):
    truth, _, _ = quast_inputs
    monkeypatch.chdir(tmp_path)
    with pytest.raises(subprocess.CalledProcessError):
        quast.quast_eval([str(tmp_path / "nope.fasta")], truth,
                         str(tmp_path / "o2"), FAKE_QUAST, run_id=9)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("sub_9_")]


def test_spades_wrapper_command(tmp_path):
    """run_spades hands SPAdes its careful-mode command: a stand-in
    executable records its argv and exits with a known code."""
    fake = tmp_path / "spades.py"
    argv_file = tmp_path / "argv"
    fake.write_text(f"#!/bin/sh\necho \"$@\" > {argv_file}\nexit 7\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "asm"
    out.mkdir()
    (out / "stale").write_text("x")
    rc = spades_wrapper.main(["-f", "R1.fq", "-r", "R2.fq", "-spades",
                              str(fake), "-t", "3", "-o", str(out)])
    assert rc == 7
    assert argv_file.read_text().split() == [
        "-1", "R1.fq", "-2", "R2.fq", "--careful", "-t", "3", "-o",
        str(out)]
    assert not out.exists()  # the old output directory is cleared first


@pytest.mark.parametrize("ratio,seed", [(2, 0), (3, 5)])
def test_sampling_equals_original(tmp_path, ratio, seed):
    with open(tmp_path / "r1.fq", "w") as a, \
            open(tmp_path / "r2.fq", "w") as b:
        for i in range(40):
            a.write(f"@r{i}\nACGTACGTAC\n+\nIIIII#IIII\n")
            b.write(f"@r{i}\nTGCATGCATG\n+\nIIIIIIII##\n")
    ins = (str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"))
    n = sampling.sample_pairs(*ins, str(tmp_path / "p1"),
                              str(tmp_path / "p2"), ratio, seed)
    jn = j_sampling.sample_pairs(*ins, str(tmp_path / "j1"),
                                 str(tmp_path / "j2"), ratio, seed)
    kept = sampling.quality_trim(*ins, str(tmp_path / "q1"),
                                 str(tmp_path / "q2"), min_len=5)
    jkept = j_sampling.quality_trim(*ins, str(tmp_path / "jq1"),
                                    str(tmp_path / "jq2"), min_len=5)
    assert (n, kept) == (jn, jkept)
    for a, b in (("p1", "j1"), ("p2", "j2"), ("q1", "jq1"), ("q2", "jq2")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_write_dot_equals_original(tmp_path):
    from vstrains_tpu.core.graph import new_view as j_new_view
    from vstrains_tpu.evals.graphviz import write_dot as j_write_dot
    from vstrains_tpu_torch.core.graph import new_view

    views = []
    for make in (new_view, j_new_view):
        v = make()
        a = v.add_vertex("a", 3.5, "ACGT")
        b = v.add_vertex('b"q', 1.25, "GG")
        v.add_edge(a, b, 1).flow = 2.0
        views.append(v)
    graphviz.write_dot(views[0], str(tmp_path / "p.dot"))
    j_write_dot(views[1], str(tmp_path / "j.dot"))
    text = (tmp_path / "p.dot").read_text()
    assert text == (tmp_path / "j.dot").read_text()
    assert '"a" -> "b\\"q" [label="2.0"' in text
