"""The reference against the program on the CPU at a tiny size, the
frozen generator's digest, and the control at a size where int16
counters wrap."""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

from portbench import check, control, data
from portbench.reference import pe_links, pipeline

from conftest import ROOT, TINY, TINY_BATCH, tiny_cell

# sha256 of the four files that the frozen generator writes for the
# tiny flagship (coverage 60, seed 0), under any PYTHONHASHSEED
TINY_DIGESTS = {
    "gfa": "09cf3432b5bec9fd5e2e1242b55ddf68b9d92ceed6e4f06bc1e6a7b48950869a",
    "paths": "36b560aecf799c6789f4a85a129df3d3a1e20dbe408e9fc0369a20001d25f885",
    "fwd": "251859710901aaef8cfcd082d1ff99107b39a9f8a6d4c9b11467e15a5abb99dd",
    "rve": "0c6d15817db37391c7241a44240e7ef86248955a3b7a5ac149ac85f203873379",
}


def _tiny_paths(seed=0):
    cell = tiny_cell("hiv_labmix.sample")
    return data.dataset(cell.config["name"], cell.config["dataset"], seed,
                        lambda m: None)


def _digests(paths):
    out = {}
    for key, path in paths.items():
        with open(path, "rb") as fh:
            out[key] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_generator_digest(tmp_path):
    got = _digests(_tiny_paths())
    assert got == TINY_DIGESTS
    code = ("import sys, json, hashlib; sys.path.insert(0, %r);"
            "from portbench.gen import hivsim;"
            "ds = hivsim.make_hiv_dataset(sys.argv[1], coverage=%r, seed=0);"
            "print(json.dumps([hashlib.sha256(open(p, 'rb').read())"
            ".hexdigest() for p in (ds.gfa_path, ds.paths_path)]))"
            % (ROOT, TINY["coverage"]))
    outs = set()
    for hs in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hs)
        res = subprocess.run([sys.executable, "-c", code,
                              str(tmp_path / hs)], env=env,
                             capture_output=True, text=True, check=True)
        outs.add(res.stdout.strip())
    assert len(outs) == 1
    assert outs.pop() == '["%s", "%s"]' % (got["gfa"], got["paths"])


def test_reference_equals_port_links():
    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.ops.pe_infer import (build_kmer_table,
                                                 infer_pe_links)
    paths = _tiny_paths()
    ids, seqs, k = data.read_gfa(paths["gfa"])
    reads = pe_links.load_reads(paths["fwd"], paths["rve"], k + 1)
    ref = pe_links.pe_links(seqs, reads, k, "cpu", block=300)
    rp = load_read_pairs(paths["fwd"], paths["rve"], k + 1,
                         pad_to_multiple=32)
    got = infer_pe_links(ids, seqs, rp, k, batch_size=TINY_BATCH,
                         table=build_kmer_table(seqs, k + 1), device="cpu")
    assert ref.used_reads == rp.used_reads and ref.n_reads == rp.n_reads
    assert int(ref.node_mat.sum()) > 0 and int(ref.short_mat.sum()) > 0
    assert check.links_differ(got.node_mat, got.short_mat, ref.node_mat,
                              ref.short_mat) == 0
    # the order of the pairs changes nothing
    o = data.rng(7).permutation(reads.num_pairs)
    perm = pe_links.Reads(reads.fwd[o], reads.fwd_len[o], reads.rve[o],
                          reads.rve_len[o], reads.n_reads, reads.short_reads)
    again = pe_links.pe_links(seqs, perm, k, "cpu", block=200)
    assert torch.equal(again.node_mat, ref.node_mat)
    assert torch.equal(again.short_mat, ref.short_mat)


def test_reference_sample_equals_port_cli(tmp_path):
    from vstrains_tpu_torch import cli
    paths = _tiny_paths()
    out = str(tmp_path / "program")
    rc = cli.main(["-a", "spades", "-g", paths["gfa"], "-p", paths["paths"],
                   "-fwd", paths["fwd"], "-rve", paths["rve"], "-o", out,
                   "--pe-batch-size", str(TINY_BATCH), "--device", "cpu"])
    assert rc == 0
    _, _, k = data.read_gfa(paths["gfa"])
    reads = pe_links.load_reads(paths["fwd"], paths["rve"], k + 1)
    ref = str(tmp_path / "reference")
    ids, links = pipeline.run_sample(paths["gfa"], paths["paths"], reads,
                                     ref, "cpu")
    assert check.sample_checks(out, ref, ids, links) == {
        "pe_links_differ": 0, "files_differ": 0}
    # a file of the links that differs in one count is seen
    pe = os.path.join(out, "aln", "pe_info")
    lines = open(pe).read().splitlines(keepends=True)
    u, v, c = lines[5].rstrip("\n").split(":")
    lines[5] = f"{u}:{v}:{int(c) + 1}\n"
    open(pe, "w").write("".join(lines))
    assert check.sample_checks(out, ref, ids, links)["pe_links_differ"] == 1


def test_dataset_follows_the_seed():
    """Each seed its own graph and reads, cached under its own name; the
    same seed the same files; a seed past 32 bits is taken."""
    a, again = _tiny_paths(3), _tiny_paths(3)
    assert a == again
    assert "-3-" in os.path.basename(os.path.dirname(a["gfa"]))
    b = _tiny_paths(2**31 + 5)
    da, db = _digests(a), _digests(b)
    assert all(da[key] != db[key] for key in da)
    assert _digests(_tiny_paths(0)) == TINY_DIGESTS


def test_node_count_is_held_to_the_band():
    """The graph of every seed has a node count in the configuration's
    band, and the generator builds the graph that was counted."""
    import json
    from portbench.gen.nodes import node_count
    spec = tiny_cell("hiv_labmix.sample").config["dataset"]
    lo, hi = spec["nodes"]
    for seed in (3, 2**31 + 5):
        paths = _tiny_paths(seed)
        with open(os.path.join(os.path.dirname(paths["gfa"]), "done")) as fh:
            stats = json.load(fh)["stats"]
        assert lo <= stats["num_nodes"] <= hi
        gseed, _ = data.pick_seed(spec, seed)
        assert stats["generator_seed"] == gseed
        assert node_count(spec["generator"], gseed,
                          spec["params"]) == stats["num_nodes"]
        assert len(data.read_gfa(paths["gfa"])[0]) == stats["num_nodes"]


def test_cache_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(data, "KEEP", 2)
    dirs = [os.path.dirname(_tiny_paths(s)["gfa"]) for s in (21, 22, 23)]
    assert [os.path.exists(d) for d in dirs] == [False, True, True]


@pytest.mark.parametrize("name", ["hiv_labmix.sample",
                                  "hiv_labmix.pe_engine"])
def test_control_fails(tmp_path, name):
    """The control (windows matched by one 32-bit hash of the k-mer)
    through a run's comparisons and limits, at a test's size: the
    flagship's recipe at 2,000x, 27,877 usable pairs. Some spurious
    matches saturate a node, so the links differ and `correct` is
    false."""
    cell = tiny_cell(name)
    cell.config["dataset"]["params"]["coverage"] = 2000.0
    cell.config["name"] = "control_hiv_labmix"
    out = control.control(cell, 0, 32, torch.device("cpu"), str(tmp_path))
    assert out["correct"] is False
    assert out["checks"]["pe_links_differ"]["value"] > 0
    assert out["checks"]["pe_links_differ"]["limit"] == 0
