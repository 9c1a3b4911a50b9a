"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration in `configs/<config>.json`, its traffic in
`traffic/<mix>.json` (which names its loop, `loops/<loop>.py`), and each
metric's reader in `metrics/<metric>.py`."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: List[dict]
    per_layer: List[dict]


def load(path: str = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def cell(spec: dict, name: str) -> Cell:
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, w, _json("configs", w["config"]),
                _json("traffic", w["traffic"]), e2e, layer)


def _module(path: str, label: str):
    mod_spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(run)` of `metrics/<metric>.py`."""
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   f"portbench_metric_{metric.replace('.', '_')}").read
