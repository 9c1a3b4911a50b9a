#!/usr/bin/env python3
"""Kernel times of two checkouts of the port on one CUDA card, in turns.

    python3 tools/torch_kernel_ab.py --base DIR [--out PATH]

DIR is another checkout of the repository (for example the parent
commit unpacked with `git archive`). Each turn runs in a child process
that builds that checkout's kernels (`vstrains_tpu_torch/csrc/`) and
times, with CUDA events after warm-up, the kernels this repository
redesigns at the shapes its paths give them:

  * pair_counts at the HIV dense batch (B = 16,384, N = 773);
  * sort_rows, (key, val) and key-only, at the N = 50k sparse tail
    (32,768 x 285) and the HIV sparse tail (65,536 x 402).

Inputs are made from fixed numpy seeds, so both checkouts see the same
data. The turns go base, this, this, base; the result (the card's name
and power limit, every turn's times and each shape's mean per checkout)
is printed as one JSON line and written to PATH when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from vstrains_tpu_torch.ops import cuda_kernels as ck

def ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters

dev = torch.device("cuda")
out = {}
rng = np.random.RandomState(0)
B, N = 16384, 773
f, r = (torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)
        for _ in range(2))
acc = [torch.zeros((N, N), dtype=torch.int64, device=dev) for _ in range(2)]
out[f"pair_counts B={B} N={N}"] = ms(lambda: ck.pair_counts(f, r, *acc))
for R, C in ((32768, 285), (65536, 402)):
    key = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    val = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    out[f"sort_rows (key, val) {R}x{C}"] = ms(lambda: ck.sort_rows(key, val))
    out[f"sort_rows key-only {R}x{C}"] = ms(lambda: ck.sort_rows(key))
print(json.dumps(out))
"""


def turn(root: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _CHILD, root],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    roots = {"base": os.path.abspath(args.base), "this": REPO}
    turns = [(name, turn(roots[name]))
             for name in ("base", "this", "this", "base")]
    mean = {name: {k: sum(t[k] for n, t in turns if n == name) / 2
                   for k in turns[0][1]} for name in roots}
    res = {"card": smi, "turns": turns, "mean_ms": mean}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
