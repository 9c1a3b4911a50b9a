"""The sparse engine's cell: the loop `pe_engine_coo` on a tiny sparse
run (its check reads `correct` true, and false for a planted fault in
the COO result), the entries of the new cells and metrics, the readers
of the sparse spans and counters, and `sparse_roofline` (at most 100% on
a stub trace of a tiny run, nothing to read without a trace).

The tiny datasets have too few pairs for a batch above the dense
engine's budget (the engine clamps a batch to the pairs it has), so the
sparse route is taken by lowering the budget."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import data, run, spec, sparse_bounds

from conftest import tiny_cell

NEW_CELLS = ["hcmv3.pe_engine"]
NEW_METRICS = {"pe_wait_s": ("program_span", "pe.wait"),
               "pe_coo_s": ("program_span", "pe.coo"),
               "pe_coo_mkeys": ("program_counter", "pe.coo_keys"),
               "pe_sparse_retries": ("program_counter", "pe.sparse_retries"),
               "sparse_roofline": ("device_trace", None)}
SHARED = ["pe_pairs_per_s", "pe_pass_p95_s", "device_idle.engine",
          "pe_table_build_s", "pe_table_upload_s", "pe_pack_s",
          "pe_upload_s", "pe_drain_s", "pe_h2d_mb", "pe_d2h_mb"]
TINY = "hiv_labmix.pe_engine_coo"


@pytest.fixture
def sparse_route(monkeypatch):
    from vstrains_tpu_torch.ops import pe_infer
    monkeypatch.setattr(pe_infer, "dense_budget_rows", lambda n: 256)


def _run(name=TINY):
    return run.run_cell(tiny_cell(name), 12345, 0.5, False,
                        torch.device("cpu"), time.time())


def test_tiny_sparse_run_is_correct(sparse_route, capsys):
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["pe_links_differ"]["value"] == 0
    assert "route: sparse engine (PESparseResult)" in capsys.readouterr().err


def test_tiny_dense_run_is_correct(capsys):
    out = _run()
    assert out["correct"], out["checks"]
    assert "route: dense engine (PEResult)" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["count", "key", "repeat"])
def test_coo_fault_is_caught(sparse_route, monkeypatch, kind):
    from vstrains_tpu_torch.ops import pe_infer
    original = pe_infer.infer_pe_links

    def bad(*args, **kw):
        res = original(*args, **kw)
        if kind == "count":  # one count altered
            res.pair_counts = res.pair_counts.copy()
            res.pair_counts[len(res.pair_counts) // 2] += 1
        elif kind == "key":  # one key moved outside the matrix
            res.short_keys = res.short_keys.copy()
            res.short_keys[-1] = len(res.ids) ** 2
        else:  # a key given twice, its count split
            res.pair_keys = np.concatenate([res.pair_keys[:1],
                                            res.pair_keys])
            res.pair_counts = np.concatenate([[0], res.pair_counts])
        return res
    monkeypatch.setattr(pe_infer, "infer_pe_links", bad)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["pe_links_differ"]["value"] >= 1


def test_new_cells_and_metrics():
    s = spec.load()
    cells = {w["name"]: w for w in s["workloads"]}
    for name in NEW_CELLS:
        assert cells[name]["chips"] == 1
        cell = spec.cell(s, name)
        assert cell.traffic["loop"] == "pe_engine_coo"
        assert {m["name"] for m in cell.end_to_end} == {"pe_pairs_per_s",
                                                        "setup_s"}
        got = {m["name"] for m in cell.per_layer}
        assert got == (set(SHARED) - {"pe_pairs_per_s"}) | set(NEW_METRICS)
    assert cells["hcmv3.pe_engine"]["traffic"] == "pe_engine_coo"
    assert spec.cell(s, "hcmv3.pe_engine").traffic["pe_batch_size"] == 16384
    entries = {m["name"]: m for m in s["end_to_end"] + s["per_layer"]}
    for name in SHARED:
        assert entries[name]["workloads"][-1:] == NEW_CELLS
    assert "hcmv3.pe_engine" not in entries["engine_roofline"]["workloads"]
    for name, (source, _) in NEW_METRICS.items():
        m = entries[name]
        assert m["source"] == source and m["workloads"] == NEW_CELLS
        assert m["moves"] == "pe_pairs_per_s"


@pytest.mark.parametrize("metric", sorted(n for n, (_, p) in
                                          NEW_METRICS.items() if p))
def test_sparse_readers(monkeypatch, metric):
    from vstrains_tpu_torch.utils import tracing
    source, name = NEW_METRICS[metric]
    read = spec.reader(metric)
    runs = SimpleNamespace(setup_s=1.0, window_s=2.0, trace=None, work={},
                           records=[{"seconds": 0.1, "pairs": 10,
                                     "failed": False}] * 4)
    monkeypatch.setattr(tracing, "profiled", lambda: {
        "spans": [], "span_ns": {}, "counters": {}, "dropped": 0})
    assert read(runs) is None
    got = {"spans": [], "span_ns": {"pe.drain": 1}, "counters": {},
           "dropped": 0}
    key = "span_ns" if source == "program_span" else "counters"
    got[key][name] = 8_000_000
    monkeypatch.setattr(tracing, "profiled", lambda: got)
    want = {"pe_wait_s": 0.002, "pe_coo_s": 0.002, "pe_coo_mkeys": 2.0,
            "pe_sparse_retries": 2_000_000}[metric]
    assert read(runs) == pytest.approx(want)


def _tiny_passes(passes=2):
    """A tiny sparse run's loop, its step records and work, built by hand."""
    cell = tiny_cell(TINY)
    cfg = cell.config
    paths = data.dataset(cfg["name"], cfg["dataset"], 4, run.log)
    ctx = run.Ctx(cell.name, cfg, cell.traffic, paths, torch.device("cpu"),
                  4, data.rng(4), "/nonexistent")
    from portbench.loops.pe_engine_coo import Loop
    loop = Loop(ctx)
    recs = [loop.step() for _ in range(passes)]
    checks = loop.check(recs)
    return recs, ctx.work, checks


def test_sparse_roofline_on_a_stub_trace(sparse_route):
    recs, work, checks = _tiny_passes()
    assert checks["pe_links_differ"] == 0
    assert work["sat_entries"] > 0
    assert work["pair_links"] > 0 and work["short_links"] >= work[
        "sat_entries"]
    read = spec.reader("sparse_roofline")
    busy = [r["seconds"] for r in recs]
    stub = SimpleNamespace(busy_s=sum(busy), window_s=2 * sum(busy),
                           step_busy_s=busy)
    got = read(SimpleNamespace(setup_s=1.0, window_s=1.0, records=recs,
                               trace=stub, work=work))
    assert 0 < got <= 100
    # busy exactly the least time reads 100%
    least = sum(s["bound_ms"] for s in
                sparse_bounds.pass_steps(work).values()) * 1e-3
    stub.step_busy_s = [least] * len(recs)
    assert read(SimpleNamespace(setup_s=1.0, window_s=1.0, records=recs,
                                trace=stub, work=work)) == pytest.approx(100)
    assert read(SimpleNamespace(setup_s=1.0, window_s=1.0, records=recs,
                                trace=None, work=work)) is None
    dense_work = {k: v for k, v in work.items() if k != "sat_entries"}
    assert read(SimpleNamespace(setup_s=1.0, window_s=1.0, records=recs,
                                trace=stub, work=dense_work)) is None
