"""BENCHMARK.json against the contract's limits, and every file it
names found by name."""

import json
import os
import re
from typing import Dict, List

from portbench import spec

from conftest import ROOT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"end_to_end": {"host_clock", "device_trace"},
           "per_layer": {"device_trace", "program_span", "program_counter",
                         "host_clock"}}


def _spec():
    return spec.load()


def _names(s: dict) -> Dict[str, List[str]]:
    """Every name, unit and key of `reduced` that the contract restricts."""
    out = {"name": [], "unit": []}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        out["name"] += [x["name"] for x in s[kind]]
    out["name"] += [w["config"] for w in s["workloads"]]
    out["name"] += [w["traffic"] for w in s["workloads"]]
    out["name"] += [k for c in s["configs"] for k in c["reduced"]]
    out["unit"] = [m["unit"] for k in ("end_to_end", "per_layer")
                   for m in s[k]]
    return out


def test_keys_and_limits():
    s = _spec()
    assert set(s) == TOP
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        for entry in s[kind]:
            extra = {"workloads"} if kind in SOURCES else set()
            assert keys <= set(entry) <= keys | extra, (kind, entry)
    for kind in SOURCES:
        for m in s[kind]:
            assert m["source"] in SOURCES[kind]
            assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text():
    s = _spec()
    got = _names(s)
    for name in got["name"]:
        assert spec.NAME.match(name), name
    for unit in got["unit"]:
        assert spec.UNIT.match(unit), unit
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in s[kind]]
        assert len(names) == len(set(names)), kind
    texts = ([w["why"] for w in s["workloads"]]
             + [c["why"] for c in s["configs"]]
             + [c["source"] for c in s["configs"]]
             + [m["layer"] for m in s["per_layer"]] + s["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for c in s["configs"]:
        assert len(c["reduced"]) <= 16


def test_cells_and_metrics():
    s = _spec()
    configs = {c["name"] for c in s["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in s["workloads"]} == configs
    assert all(w["chips"] == 1 for w in s["workloads"])
    e2e = {m["name"] for m in s["end_to_end"]}
    for w in s["workloads"]:
        cell = spec.cell(s, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
    for m in s["per_layer"]:
        assert m["moves"] in e2e
    for m in s["per_layer"]:
        layer = m["layer"]
        assert 1 <= len(layer) <= 200 and not set(layer) & {"\n", "\t"}
        assert layer == layer.strip(), m["name"]


def test_files_found_by_name():
    """Each configuration, traffic mix, loop and metric is a file of its
    own, found from the name in BENCHMARK.json."""
    s = _spec()
    here = os.path.join(ROOT, "portbench")
    for c in s["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(path) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in s["workloads"]:
        cell = spec.cell(s, w["name"])
        loop = cell.traffic["loop"]
        assert os.path.exists(os.path.join(here, "loops", f"{loop}.py"))
    for kind in ("end_to_end", "per_layer"):
        for m in s[kind]:
            assert callable(spec.reader(m["name"]))


def test_paths_hold_only_the_benchmark():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_readers_need_no_loop_name():
    """Each reader takes the fields it needs from a run, and finds
    nothing to read in a run that lacks them; each loop declares the
    limits of its checks."""
    import importlib
    from types import SimpleNamespace
    s = _spec()
    empty = SimpleNamespace(setup_s=1.0, window_s=2.0, records=[
        {"seconds": 1.0, "failed": False}], trace=None, work={})
    for kind in ("end_to_end", "per_layer"):
        for m in s[kind]:
            got = spec.reader(m["name"])(empty)
            assert got is None or m["name"] == "setup_s", m["name"]
    for w in s["workloads"]:
        loop = spec.cell(s, w["name"]).traffic["loop"]
        limits = importlib.import_module(f"portbench.loops.{loop}").Loop.LIMITS
        assert limits and all(v >= 0 for v in limits.values())
