"""A run of each tiny cell with the timed path broken underneath: the
harness's look for a chip skipped, `correct` has to come out false for
each fault the cell can have. (There is one chip, so no exchange
between chips to leave out.)"""

import time

import numpy as np
import pytest
import torch

from portbench import run

from conftest import tiny_cell

CELLS = ("hiv_labmix.sample", "hiv_labmix.pe_engine")


def _faulty(kind, original):
    def infer(ids, seqs, reads, *args, **kw):
        if kind == "half":  # half of the batch left out
            from vstrains_tpu_torch.core.fastq import ReadPairBatch
            h = reads.num_pairs // 2
            reads = ReadPairBatch(reads.fwd_codes[:h], reads.fwd_len[:h],
                                  reads.rve_codes[:h], reads.rve_len[:h],
                                  reads.n_reads, reads.short_reads, h)
        res = original(ids, seqs, reads, *args, **kw)
        if kind == "unchanged":  # the counters returned as they started
            res.node_mat = np.zeros_like(res.node_mat)
            res.short_mat = np.zeros_like(res.short_mat)
        elif kind == "altered":  # one count altered where it is produced
            i, j = np.argwhere(res.node_mat > 0)[0]
            res.node_mat[i, j] += 1
        return res
    return infer


def _run(name):
    cell = tiny_cell(name)
    return run.run_cell(cell, 12345, 0.5, False, torch.device("cpu"),
                        time.time())


def test_sound_runs_are_correct():
    for name in CELLS:
        out = _run(name)
        assert out["correct"], (name, out["checks"])
        assert out["attempted"] >= 1 and out["failed"] == 0
        assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_engine_fault_is_caught(monkeypatch, name, kind):
    from vstrains_tpu_torch import pipeline
    from vstrains_tpu_torch.ops import pe_infer
    bad = _faulty(kind, pe_infer.infer_pe_links)
    monkeypatch.setattr(pe_infer, "infer_pe_links", bad)
    monkeypatch.setattr(pipeline, "infer_pe_links", bad)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["pe_links_differ"]["value"] > 0


def test_strain_output_fault_is_caught(monkeypatch):
    """A sample's answer altered where it is written: one base of
    `strain.fasta`."""
    from vstrains_tpu_torch import pipeline
    original = pipeline.contig_dict_to_fasta

    def write(view, contigs, path, *args, **kw):
        original(view, contigs, path, *args, **kw)
        if path.endswith("/strain.fasta"):
            text = open(path).read().splitlines(keepends=True)
            i = next(n for n, line in enumerate(text)
                     if not line.startswith(">"))
            line = text[i]
            text[i] = ("C" if line[0] != "C" else "G") + line[1:]
            open(path, "w").write("".join(text))
    monkeypatch.setattr(pipeline, "contig_dict_to_fasta", write)
    out = _run("hiv_labmix.sample")
    assert not out["correct"]
    assert out["checks"]["files_differ"]["value"] > 0
    assert out["checks"]["pe_links_differ"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_raises_counts_as_failed(monkeypatch, name):
    from vstrains_tpu_torch import pipeline
    from vstrains_tpu_torch.ops import pe_infer

    def broken(*args, **kw):
        raise RuntimeError("planted fault")
    monkeypatch.setattr(pe_infer, "infer_pe_links", broken)
    monkeypatch.setattr(pipeline, "infer_pe_links", broken)
    cell = tiny_cell(name)
    loop_mod = __import__(f"portbench.loops.{cell.traffic['loop']}",
                          fromlist=["Loop"])
    # the warm-up runs the broken path too: skip it, as a run cannot
    monkeypatch.setattr(loop_mod.Loop, "warm_up", lambda self: None)
    out = run.run_cell(cell, 4, 0.3, False, torch.device("cpu"), time.time())
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1
