"""The port never needs JAX or the JAX package: a fresh interpreter with
an import blocker imports every `vstrains_tpu_torch` module and runs the
tiny pipeline on the CPU; no `jax` import is attempted and no top-level
`vstrains_tpu` module is loaded. And no port source names either."""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vstrains_tpu_torch")

_CHILD = r"""
import importlib, json, os, sys

attempts = []

class Blocker:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "vstrains_tpu"):
            attempts.append(name)
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocker())
import torch
torch.set_num_threads(1)
import vstrains_tpu_torch
root = os.path.dirname(os.path.dirname(vstrains_tpu_torch.__file__))
mods = []
for d, _, files in os.walk(os.path.dirname(vstrains_tpu_torch.__file__)):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f[:-3]), root)
            mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
mods.sort()
for m in mods:
    importlib.import_module(m)

from vstrains_tpu_torch import cli
from vstrains_tpu_torch.evals.synth import make_dataset
base = os.getcwd()
ds = make_dataset(base + "/data", num_strains=2, num_bubbles=2,
                  pairs_per_strain=150, seed=3)
rc = cli.main(["-a", "spades", "-g", ds.gfa_path, "-p", ds.paths_path,
               "-fwd", ds.fwd_path, "-rve", ds.rve_path,
               "-o", base + "/out", "--pe-batch-size", "128",
               "--device", "cpu"])
loaded = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "vstrains_tpu"))
print(json.dumps({"rc": rc, "attempts": attempts, "loaded": loaded,
                  "modules": mods}))
"""


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED="0")
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert out["attempts"] == []
    assert out["loaded"] == []
    assert "vstrains_tpu_torch.ops.pe_infer" in out["modules"]
    assert "vstrains_tpu_torch.ops.cuda_kernels" in out["modules"]


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import vstrains_tpu\b(?!_torch)"
    r"|from vstrains_tpu(\.|\s+import)(?!_torch))")


def test_no_port_source_imports_jax_or_the_jax_package():
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for n, line in enumerate(fh, 1):
                        if _FORBIDDEN.search(line):
                            bad.append(f"{path}:{n}: {line.strip()}")
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        bad += [f"chip_smoke.py: {x.strip()}" for x in fh
                if _FORBIDDEN.search(x)]
    assert not bad, "\n".join(bad)
