"""The readers of the program's own spans and counters
(`portbench/program.py`, `metrics/pe_*_s.py`, `metrics/pe_*_mb.py`):
nothing to read without profiled spans or without a pass, and the mean
over the window's passes of a registry filled by hand."""

from types import SimpleNamespace

import pytest

from portbench import spec

SPANS = {"pe_table_build_s": "pe.table_build",
         "pe_table_upload_s": "pe.table_upload", "pe_pack_s": "pe.pack",
         "pe_upload_s": "pe.upload", "pe_drain_s": "pe.drain"}
COUNTERS = {"pe_h2d_mb": "pe.h2d_bytes", "pe_d2h_mb": "pe.d2h_bytes"}
CELLS = ["zikv15.pe_engine", "hiv_labmix.pe_engine"]


def _run(passes: int, failed: int = 0):
    records = ([{"seconds": 0.1, "pairs": 1000, "failed": False}] * passes
               + [{"seconds": 0.1, "failed": True}] * failed)
    return SimpleNamespace(setup_s=1.0, window_s=2.0, records=records,
                           trace=None, work={})


def _registry(monkeypatch, got):
    from vstrains_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "profiled", lambda: got)


def test_entries_of_the_new_metrics():
    s = spec.load()
    entries = {m["name"]: m for m in s["per_layer"]}
    for name in list(SPANS) + list(COUNTERS):
        m = entries[name]
        assert m["moves"] == "pe_pairs_per_s" and m["better"] == "lower"
        assert m["workloads"] == CELLS
        assert m["source"] == ("program_span" if name in SPANS
                               else "program_counter")
        assert m["unit"] == ("s" if name in SPANS else "MB")


@pytest.mark.parametrize("metric", sorted(SPANS) + sorted(COUNTERS))
def test_none_without_spans_or_passes(monkeypatch, metric):
    read = spec.reader(metric)
    _registry(monkeypatch, {"spans": [], "span_ns": {}, "counters": {},
                            "dropped": 0})
    assert read(_run(3)) is None
    full = {"spans": [("pe.pack", 0, 5, 1)],
            "span_ns": {v: 4_000_000_000 for v in SPANS.values()},
            "counters": {v: 300_000_000 for v in COUNTERS.values()},
            "dropped": 0}
    _registry(monkeypatch, full)
    assert read(_run(0, failed=2)) is None
    assert read(_run(2)) is not None


def test_none_on_a_program_without_the_registry(monkeypatch):
    from vstrains_tpu_torch.utils import tracing
    monkeypatch.delattr(tracing, "profiled")
    for metric in list(SPANS) + list(COUNTERS):
        assert spec.reader(metric)(_run(3)) is None


def test_means_over_the_passes(monkeypatch):
    span_ns = {v: (i + 1) * 1_000_000_000 for i, v in
               enumerate(SPANS.values())}
    _registry(monkeypatch, {
        "spans": [(name, 0, ns, 1) for name, ns in span_ns.items()],
        "span_ns": span_ns,
        "counters": {"pe.h2d_bytes": 40_000_000, "pe.d2h_bytes": 598_000_000,
                     "pe.batches": 80},
        "dropped": 0})
    run = _run(4, failed=1)  # the failed step is no pass
    for metric, name in SPANS.items():
        assert spec.reader(metric)(run) == pytest.approx(
            span_ns[name] * 1e-9 / 4)
    assert spec.reader("pe_h2d_mb")(run) == pytest.approx(10.0)
    assert spec.reader("pe_d2h_mb")(run) == pytest.approx(149.5)


def test_traced_tiny_cell_reports_the_seven():
    """A traced run of the tiny engine cell on the CPU reads every new
    metric from the program, and the result's D2H is the two N x N int64
    matrices a pass."""
    import time

    import torch

    from conftest import tiny_cell
    from portbench import data, run

    cell, seed = tiny_cell("hiv_labmix.pe_engine"), 2147483999
    out = run.run_cell(cell, seed, 1.0, True, torch.device("cpu"),
                       time.time())
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in list(SPANS) + list(COUNTERS):
        assert got[name]["value"] > 0, name
    paths = data.dataset(cell.config["name"], cell.config["dataset"], seed,
                         lambda msg: None)
    n = len(data.read_gfa(paths["gfa"])[0])
    assert got["pe_d2h_mb"]["value"] == pytest.approx(2 * n * n * 8 / 1e6)
