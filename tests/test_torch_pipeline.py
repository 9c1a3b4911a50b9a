"""The port's CLI on the CPU vs the JAX package's CLI, end to end, on the
verify-recipe synthetic dataset (3 strains, 3 bubbles, seed 77): the
compared output files must be byte-equal, to each other and to the
digests the JAX run recorded in tests/data/torch_port_expected.json."""

import hashlib
import json
import os

import pytest
import torch

from vstrains_tpu import cli as jax_cli
from vstrains_tpu.evals.synth import make_dataset
from vstrains_tpu_torch import cli as port_cli
from vstrains_tpu_torch import pe_cli as port_pe_cli
from vstrains_tpu_torch.evals.nga50 import load_fasta

torch.set_num_threads(1)

EXPECTED = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_expected.json")
with open(EXPECTED) as _fh:
    SYNTH = json.load(_fh)["synth"]


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _argv(data, out):
    return [a.replace("{data}", data).replace("{out}", out)
            for a in SYNTH["cli"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth")
    data = str(base / "data")
    kw = dict(SYNTH["generator"]["kwargs"])
    ds = make_dataset(data, **kw)
    outs = {"jax": str(base / "jax"), "port": str(base / "port")}
    assert jax_cli.main(_argv(data, outs["jax"])) == 0
    assert port_cli.main(_argv(data, outs["port"])
                         + ["--device", "cpu"]) == 0
    return data, ds, outs


def test_inputs_match_recorded_digests(runs):
    data, _, _ = runs
    for name, digest in SYNTH["inputs"].items():
        assert _sha(os.path.join(data, name)) == digest, name


@pytest.mark.parametrize("name", ["aln/pe_info", "aln/st_info",
                                  "gfa/split_graph_final.gfa",
                                  "strain.fasta", "strain.paths"])
def test_outputs_byte_equal_to_jax(runs, name):
    _, _, outs = runs
    with open(os.path.join(outs["port"], name), "rb") as a, \
            open(os.path.join(outs["jax"], name), "rb") as b:
        assert a.read() == b.read()
    assert _sha(os.path.join(outs["port"], name)) == SYNTH["outputs"][name]


def test_strains_are_the_planted_haplotypes(runs):
    _, ds, outs = runs
    strains = load_fasta(os.path.join(outs["port"], "strain.fasta"))
    assert set(strains.values()) == set(ds.true_haplotypes)
    with open(os.path.join(outs["port"], "timings.json")) as fh:
        stages = [s["stage"] for s in json.load(fh)["stages"]]
    assert "pe_inference" in stages


def test_pe_cli_matches_pipeline(runs, tmp_path):
    """The standalone PE CLI on the simplified graph reproduces the
    pipeline's aln/pe_info (the verify recipe's probe)."""
    data, _, outs = runs
    port = outs["port"]
    with open(os.path.join(port, "vstrains.log")) as fh:
        k = next(int(line.rsplit(":", 1)[1]) for line in fh
                 if "graph kmer size:" in line)
    out = str(tmp_path / "aln")
    assert port_pe_cli.main([
        "-g", os.path.join(port, "gfa", "s_graph_L1.gfa"), "-o", out,
        "-f", os.path.join(data, "reads_1.fastq"),
        "-r", os.path.join(data, "reads_2.fastq"), "-k", str(k),
        "--device", "cpu"]) == 0
    for name in ("pe_info", "st_info"):
        assert _sha(os.path.join(out, name)) == \
            _sha(os.path.join(port, "aln", name))


def test_cli_refuses_a_missing_device(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    data, _, _ = runs
    out = str(tmp_path / "out")
    assert port_cli.main(_argv(data, out) + ["--device", "cuda"]) == 1
    with open(os.path.join(out, "vstrains.log")) as fh:
        assert "CUDA is not available" in fh.read()


def test_cli_per_component_on_one_component(runs, tmp_path):
    """--per-component on a graph of one component takes the whole-graph
    stages, as the JAX pipeline does: the outputs equal the plain run's
    (the multi-component sample is tests/test_torch_components.py's)."""
    data, _, outs = runs
    out = str(tmp_path / "out")
    assert port_cli.main(_argv(data, out) + ["--per-component",
                                             "--device", "cpu"]) == 0
    for name in SYNTH["outputs"]:
        assert _sha(os.path.join(out, name)) == \
            _sha(os.path.join(outs["port"], name)), name
