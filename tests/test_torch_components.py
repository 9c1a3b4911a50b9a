"""The port's per-component extraction (`vstrains_tpu_torch/parallel/
components.py` and the pipeline's --per-component path) against the JAX
package on the 15-strain metaviral sample (BASELINE config 5:
`make_multi_component_dataset`, 3 components x 5 strains, seed 3): the
components, the payloads and the merged strain dicts from the JAX run's
own checkpoints, and the CLI outputs byte-equal to the JAX CLI's and to
the digests the JAX run recorded (tolerance 0: text files and integer
counts)."""

import hashlib
import json
import os

import pytest
import torch

from vstrains_tpu import cli as jax_cli
from vstrains_tpu.core.gfa import load_flipped_gfa as j_load_flipped_gfa
from vstrains_tpu.parallel import components as JC
from vstrains_tpu.utils import checkpoint as j_ckpt
from vstrains_tpu_torch import cli as port_cli
from vstrains_tpu_torch import device as port_device
from vstrains_tpu_torch.core.gfa import load_flipped_gfa
from vstrains_tpu_torch.evals.nga50 import load_fasta
from vstrains_tpu_torch.evals.synth import make_multi_component_dataset
from vstrains_tpu_torch.ops import graph_ops as port_graph_ops
from vstrains_tpu_torch.parallel import components as TC

torch.set_num_threads(1)

EXPECTED = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_expected.json")
with open(EXPECTED) as _fh:
    META = json.load(_fh)["metaviral"]
WORKERS = (1, 2)


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _argv(data, out):
    return [a.replace("{data}", data).replace("{out}", out)
            for a in META["cli"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("metaviral")
    data = str(base / "data")
    ds = make_multi_component_dataset(data, **META["generator"]["kwargs"])
    outs = {"jax": str(base / "jax")}
    assert jax_cli.main(_argv(data, outs["jax"])) == 0
    for w in WORKERS:
        outs[w] = str(base / f"port{w}")
        assert port_cli.main(_argv(data, outs[w]) + [
            "--device", "cpu", "--component-workers", str(w)]) == 0
    return data, ds, outs


def _jax_state(outs):
    """The JAX run's state at the per-component stage, from its own
    checkpoints: (GFA path of the cleaned graph, contig_dict, pe_info,
    dcpy_pe_info, delta)."""
    import numpy as np
    out = outs["jax"]
    cleaned = j_ckpt.load_stage(out, "cleaned")
    dcpy = j_ckpt.load_stage(out, "pe_links")["dcpy_pe_info"]
    gfa = os.path.join(out, "gfa", "es_graph_L2.gfa")
    view = j_load_flipped_gfa(gfa)
    delta = 0.05 * float(np.median([v.dp for v in view.graph.vertices()]))
    return gfa, cleaned["contig_dict"], cleaned["pe_info"], dcpy, delta


def test_inputs_match_recorded_digests(runs):
    data, _, _ = runs
    for name, digest in META["inputs"].items():
        assert _sha(os.path.join(data, name)) == digest, name


@pytest.mark.parametrize("name", sorted(META["outputs"]))
@pytest.mark.parametrize("workers", WORKERS)
def test_cli_per_component_byte_equal_to_jax(runs, workers, name):
    _, _, outs = runs
    got = os.path.join(outs[workers], name)
    with open(got, "rb") as a, open(os.path.join(outs["jax"], name),
                                    "rb") as b:
        assert a.read() == b.read()
    assert _sha(got) == META["outputs"][name]


@pytest.mark.parametrize("workers", WORKERS)
def test_cli_per_component_recovers_every_strain(runs, workers):
    _, ds, outs = runs
    strains = set(load_fasta(os.path.join(outs[workers],
                                          "strain.fasta")).values())
    assert len(ds.true_haplotypes) == META["strains"] == 15
    assert all(h in strains for h in ds.true_haplotypes)
    with open(os.path.join(outs[workers], "timings.json")) as fh:
        stages = [s["stage"] for s in json.load(fh)["stages"]]
    assert "per_component_extraction" in stages
    assert "disentanglement" not in stages


def test_weakly_connected_components_equal_jax(runs):
    _, _, outs = runs
    gfa = _jax_state(outs)[0]
    comps = TC.weakly_connected_components(load_flipped_gfa(gfa))
    assert comps == JC.weakly_connected_components(j_load_flipped_gfa(gfa))
    assert len(comps) == 3


def test_component_payloads_equal_jax(runs):
    _, _, outs = runs
    gfa, contigs, pe, dcpy, _ = _jax_state(outs)
    got = TC.component_payloads(load_flipped_gfa(gfa), contigs, pe, dcpy)
    want = JC.component_payloads(j_load_flipped_gfa(gfa), contigs, pe, dcpy)
    assert len(got) == 3 and got == want


@pytest.mark.parametrize("workers", WORKERS)
def test_run_components_equal_jax(runs, workers):
    """The merged strain dict, with 1 and 2 spawned workers on the CPU,
    against the JAX package's run_components on the same state."""
    _, _, outs = runs
    gfa, contigs, pe, dcpy, delta = _jax_state(outs)
    want = JC.run_components(j_load_flipped_gfa(gfa), contigs, pe, dcpy,
                             delta, workers=1)
    got = TC.run_components(load_flipped_gfa(gfa), contigs, pe, dcpy, delta,
                            "cpu", workers=workers)
    assert got == want
    assert sorted({name.rsplit("c", 1)[1] for name in got}) == ["0", "1",
                                                                  "2"]


def test_worker_computes_on_the_runs_device(runs, monkeypatch):
    """process_component opens the run's device itself: a worker called
    outside any run (as a spawned process is) sees "cpu" in its graph
    passes, not the "cuda" that code outside a run gets."""
    _, _, outs = runs
    gfa, contigs, pe, dcpy, delta = _jax_state(outs)
    payload = TC.component_payloads(load_flipped_gfa(gfa), contigs, pe,
                                    dcpy)[0]
    seen = []
    real = port_graph_ops.assign_edge_flow

    def spy(view, *a, **kw):
        seen.append(port_device.run_device())
        return real(view, *a, **kw)

    monkeypatch.setattr(port_graph_ops, "assign_edge_flow", spy)
    assert port_device.run_device() == "cuda"
    strains = TC.process_component(payload, delta, "cpu")
    assert strains
    assert seen and all(d == torch.device("cpu") for d in seen)
