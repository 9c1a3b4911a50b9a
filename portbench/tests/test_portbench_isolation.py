"""The run needs a card, and loads neither JAX nor the JAX package; the
reference and the generator import nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import run

from conftest import ROOT

HERE = os.path.join(ROOT, "portbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub):
    for dirpath, dirs, files in os.walk(os.path.join(HERE, sub)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in _sources(""):
        for top in _imports(path):
            assert top not in run.FORBIDDEN, (path, top)


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generator_import_nothing_of_the_program(sub):
    for path in _sources(sub):
        for top in _imports(path):
            assert top not in ("vstrains_tpu_torch",) + run.FORBIDDEN, (
                path, top)


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    mods = dict(sys.modules)
    mods.update({"vstrains_tpu_torch.ops": None, "vstrains_tpu_tools": None})
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    for name in ("vstrains_tpu", "vstrains_tpu.ops.pe_infer", "jax",
                 "jaxlib.xla_client", "flax.linen"):
        mods2 = dict(mods)
        mods2[name] = None
        monkeypatch.setattr(sys, "modules", mods2)
        assert run.forbidden_modules() == [name.split(".")[0]]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.reference.pipeline, portbench.gen.hivsim;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'vstrains_tpu_torch', 'vstrains_tpu', 'jax', 'jaxlib'}))"
            % ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert res.stdout.strip() == "[]"


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hiv_labmix.pe_engine", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA device" in res.stderr


def test_tiny_run_loads_no_jax(tmp_path):
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "sys.path.insert(0, %r);"
            "from conftest import tiny_cell; from portbench import run, data;"
            "data.CACHE = sys.argv[1];"
            "out = run.run_cell(tiny_cell('hiv_labmix.pe_engine'), 5, 0.2,"
            " False, torch.device('cpu'), time.time());"
            "print(out['correct'], run.forbidden_modules())"
            % (ROOT, os.path.join(HERE, "tests")))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.strip().splitlines()[-1] == "True []", res.stderr


@pytest.mark.chip
def test_tiny_cell_on_the_card(cuda_device):
    import time

    from conftest import tiny_cell
    for name in ("hiv_labmix.sample", "hiv_labmix.pe_engine"):
        out = run.run_cell(tiny_cell(name), 99, 1.0, True, cuda_device,
                           time.time())
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0
