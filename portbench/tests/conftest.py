"""Fixtures of the benchmark's own tests: tiny cells on the CPU, and the
card for the tests marked `chip`, which skip without one."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny sample: the flagship's recipe at 60x, 1,165 pairs, 773 nodes
TINY = {"coverage": 60.0}
TINY_BATCH = 512


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this case runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _cache(tmp_path_factory, monkeypatch):
    """Datasets of the tests in a directory of their own."""
    from portbench import data
    monkeypatch.setattr(data, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "data"))


def tiny_cell(name: str):
    """The cell `name` (`<config>.<traffic>`) at the tiny size: the one of
    BENCHMARK.json, or one built from the files that the name gives."""
    from portbench import spec
    s = spec.load()
    if any(w["name"] == name for w in s["workloads"]):
        cell = spec.cell(s, name)
    else:
        config, traffic = name.split(".", 1)
        cell = spec.Cell(name, {"name": name, "config": config,
                                "traffic": traffic, "chips": 1},
                         spec._json("configs", config),
                         spec._json("traffic", traffic), [], [])
    cell.config = copy.deepcopy(cell.config)
    cell.config["name"] = "tiny_" + cell.config["name"]
    cell.config["dataset"]["params"].update(TINY)
    cell.traffic = dict(cell.traffic, pe_batch_size=TINY_BATCH)
    return cell
