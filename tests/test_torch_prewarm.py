"""The port's kernel warm-up layer on the CPU: `vstrains_tpu_torch.prewarm`
against the JAX package's `vstrains_tpu.prewarm` on the same seeded
inputs (tolerance 0: widths, node counts and k are integers), and the
background kernel build (`ops._build.Prefetch`) with `_build.load`
replaced, since nothing can be built here."""

import gzip
import logging
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vstrains_tpu import prewarm as jax_prewarm
from vstrains_tpu.evals.synth import make_dataset
from vstrains_tpu_torch import cli as port_cli
from vstrains_tpu_torch import pe_cli as port_pe_cli
from vstrains_tpu_torch import prewarm as port_prewarm
from vstrains_tpu_torch.core.fastq import load_read_pairs
from vstrains_tpu_torch.ops import _build
from vstrains_tpu_torch.ops.pe_infer import _length_buckets

torch.set_num_threads(1)

PREWARM_KW = dict(num_strains=2, num_bubbles=3, pairs_per_strain=200,
                  seed=1)


def _write_library(base, lengths, rng, gz=False):
    """A FASTQ pair with reads of the given lengths (random ACGT from
    `rng`; each reverse read 10 bp shorter than its mate)."""
    fwd = os.path.join(base, "f.fastq" + (".gz" if gz else ""))
    rve = os.path.join(base, "r.fastq" + (".gz" if gz else ""))
    opener = gzip.open if gz else open
    with opener(fwd, "wt") as ff, opener(rve, "wt") as fr:
        for i, ln in enumerate(lengths):
            ln = int(ln)
            seq = "".join("ACGT"[c] for c in rng.randint(0, 4, ln))
            ff.write(f"@r{i}/1\n{seq}\n+\n{'I' * ln}\n")
            rs = seq[:ln - 10]
            fr.write(f"@r{i}/2\n{rs}\n+\n{'I' * len(rs)}\n")
    return fwd, rve


def _alternating(n, *lens):
    return [lens[i % len(lens)] for i in range(n)]


# (name, library, split_len, batch, est_pairs, expected widths)
PLAN_CASES = {
    # a uniform 60 bp make_dataset library: one bucket
    "uniform": ("synth", 22, 512, 100, [64]),
    # two length populations: two buckets, widest first
    "mixed": (_alternating(1000, 100, 240), 56, 128, 10_000, [256, 128]),
    "gzip": (_alternating(1000, 100, 240), 56, 128, 10_000, [256, 128]),
    # under four batches the engine forms no buckets
    "few_pairs": (_alternating(1000, 100, 240), 56, 128, 4 * 128 - 1,
                  [256]),
    # the 160 bucket holds 5% (< 10%): it merges into the next wider one
    "merge_up": ([100] * 450 + [150] * 50 + [240] * 500, 56, 128, 10_000,
                 [256, 128]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_widths_equals_jax(case, tmp_path):
    lib, split_len, batch, est_pairs, want = PLAN_CASES[case]
    if lib == "synth":
        ds = make_dataset(str(tmp_path), num_strains=2, num_bubbles=2,
                          pairs_per_strain=50, seed=0)
        fwd, rve = ds.fwd_path, ds.rve_path
    else:
        fwd, rve = _write_library(str(tmp_path), lib,
                                  np.random.RandomState(11),
                                  gz=case == "gzip")
    got = port_prewarm.plan_widths(fwd, rve, split_len, batch, est_pairs)
    ref = jax_prewarm.plan_widths(fwd, rve, split_len, batch, est_pairs)
    assert got == ref == want


def test_plan_widths_predict_the_length_buckets(tmp_path):
    """On a library read whole (so the head sample is all of it), the
    prediction is the widths of the buckets the engine forms."""
    rng = np.random.RandomState(5)
    lengths = rng.choice([100, 150, 200, 240], size=1200,
                         p=[0.4, 0.05, 0.25, 0.3])
    fwd, rve = _write_library(str(tmp_path), lengths, rng)
    split_len, batch = 56, 128
    reads = load_read_pairs(fwd, rve, split_len, pad_to_multiple=32)
    buckets = _length_buckets(reads, split_len, batch)
    assert buckets is not None
    want = [wd for wd, _ in buckets]
    got = port_prewarm.plan_widths(fwd, rve, split_len, batch,
                                   reads.num_pairs)
    assert got == want == jax_prewarm.plan_widths(fwd, rve, split_len,
                                                  batch, reads.num_pairs)
    assert want == [256, 224, 128]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("prewarm")),
                        **PREWARM_KW)


def _args(ds, **kw):
    return SimpleNamespace(gfa_file=ds.gfa_path, path_file=ds.paths_path,
                           fwd=ds.fwd_path, rve=ds.rve_path, min_cov=None,
                           min_len=250, pe_batch_size=512, **kw)


def _argv(ds, *extra):
    return ["-g", ds.gfa_path, "-p", ds.paths_path, "-fwd", ds.fwd_path,
            "-rve", ds.rve_path, "--pe-batch-size", "512", *extra]


@pytest.fixture
def no_build(monkeypatch):
    """Any call of the kernel build fails the test."""
    def fail(*args, **kwargs):
        raise AssertionError("the CUDA kernel library was built")
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(_build, "build", fail)


def test_prewarm_cpu_record_equals_jax(dataset, no_build):
    log = logging.getLogger("prewarm_test")
    got = port_prewarm.prewarm(_args(dataset, device="cpu"), log)
    ref = jax_prewarm.prewarm(_args(dataset), log)
    assert ref["errors"] == [] and got["errors"] == []
    for key in ("nodes", "k", "batch", "widths"):
        assert got[key] == ref[key], key
    assert got["widths"] == [64] and got["k"] == dataset.k
    assert got["device"] == "cpu" and got["engine"] == "dense"
    assert got["library"] is None and got["built"] is False
    assert set(got["warm_seconds"]) == set(got["widths"])
    # the plain versions count no launches
    assert got["launches"] == {64: {}}


def test_prewarm_main_exits_1_when_a_width_fails(dataset, no_build,
                                                 monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("warm batch failed")
    monkeypatch.setattr(port_prewarm, "infer_pe_links", fail)
    assert port_prewarm.main(_argv(dataset, "--device", "cpu")) == 1


def test_prewarm_main_exits_0_on_cpu(dataset, no_build, capsys):
    assert port_prewarm.main(_argv(dataset, "--device", "cpu")) == 0
    assert '"errors": []' in capsys.readouterr().out.strip()


def test_prewarm_refuses_a_missing_device(dataset, no_build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_prewarm.main(_argv(dataset))


def _build_threads():
    return [t for t in threading.enumerate() if t.name == "vt-kernel-build"]


def test_prefetch_on_the_cpu_starts_nothing(no_build):
    with _build.Prefetch(torch.device("cpu")) as kernels:
        assert _build_threads() == []
        kernels.join()
    assert kernels.wait_seconds == 0.0
    assert kernels.report() is None


def test_cli_on_the_cpu_never_builds(dataset, no_build, tmp_path):
    out = str(tmp_path / "out")
    try:
        assert port_cli.main(["-a", "spades", *_argv(dataset), "-o", out,
                              "--device", "cpu"]) == 0
    finally:
        _drop_cli_handlers()
    with open(os.path.join(out, "vstrains.log")) as fh:
        assert "CUDA kernel library" not in fh.read()


def test_prefetch_join_reraises_the_build_error(monkeypatch):
    err = RuntimeError("nvcc failed on ['stats_accum.cu']:\nerror: boom")

    def fail():
        raise err
    monkeypatch.setattr(_build, "load", fail)
    with _build.Prefetch(torch.device("cuda")) as kernels:
        with pytest.raises(RuntimeError) as got:
            kernels.join()
        assert got.value is err
        kernels.join()  # raised once, to the caller that joined
    assert _build_threads() == []


def test_prefetch_join_waits_and_reports_the_wait(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda: time.sleep(0.3))
    with _build.Prefetch(torch.device("cuda")) as kernels:
        kernels.join()
        assert _build_threads() == []
    assert 0.2 <= kernels.wait_seconds < 30
    line = kernels.report()
    assert f"waited {kernels.wait_seconds:.3f} s" in line
    assert _build.library_path() in line


class _CudaPrefetch(_build.Prefetch):
    """The prefetch a CUDA run starts, in a run on the CPU."""

    def __init__(self, device):
        super().__init__(torch.device("cuda"))


def _drop_cli_handlers():
    logger = logging.getLogger(f"vstrains-tpu-torch {port_cli.__version__}")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("entry", ["cli", "pe_cli"])
def test_a_failed_build_fails_the_pe_stage(entry, dataset, monkeypatch,
                                           tmp_path):
    """A build error reaches the user from the PE stage's join, with the
    compiler's output; no path catches it and carries on."""
    def fail():
        raise RuntimeError("nvcc failed on ['pair_counts.cu']:\nptxas "
                           "error")
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(_build, "Prefetch", _CudaPrefetch)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="ptxas error"):
        if entry == "cli":
            try:
                port_cli.main(["-a", "spades", *_argv(dataset), "-o", out,
                               "--device", "cpu"])
            finally:
                _drop_cli_handlers()
        else:
            port_pe_cli.main(["-g", dataset.gfa_path, "-o", out,
                              "-f", dataset.fwd_path, "-r",
                              dataset.rve_path, "-k", str(dataset.k),
                              "--device", "cpu"])
    aln = os.path.join(out, "aln" if entry == "cli" else "", "pe_info")
    assert not os.path.exists(aln)
    assert _build_threads() == []


def test_cli_logs_the_build_line_after_the_pe_stage(dataset, monkeypatch,
                                                    tmp_path):
    monkeypatch.setattr(_build, "load", lambda: time.sleep(0.1))
    monkeypatch.setattr(_build, "Prefetch", _CudaPrefetch)
    out = str(tmp_path / "out")
    try:
        assert port_cli.main(["-a", "spades", *_argv(dataset), "-o", out,
                              "--device", "cpu"]) == 0
    finally:
        _drop_cli_handlers()
    with open(os.path.join(out, "vstrains.log")) as fh:
        log = fh.read()
    lines = [x for x in log.splitlines() if "CUDA kernel library" in x]
    assert len(lines) == 1 and "waited" in lines[0]
    assert log.index("PE link matrices written") < log.index(lines[0])


def test_a_resumed_run_past_the_pe_stage_starts_no_build(dataset,
                                                         monkeypatch,
                                                         tmp_path):
    out = str(tmp_path / "out")
    argv = ["-a", "spades", *_argv(dataset), "-o", out, "--device", "cpu"]
    try:
        assert port_cli.main(argv) == 0

        def no_prefetch(device):
            raise AssertionError("a build started past the PE stage")
        monkeypatch.setattr(_build, "Prefetch", no_prefetch)
        assert port_cli.main(argv + ["--resume"]) == 0
    finally:
        _drop_cli_handlers()
