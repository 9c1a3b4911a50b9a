#!/usr/bin/env python3
"""Kernel times of two checkouts of the port on one CUDA card, in turns.

    python3 tools/torch_kernel_ab.py --base DIR [--out PATH]

DIR is another checkout of the repository (for example the parent
commit unpacked with `git archive`). Each turn runs in a child process
that builds that checkout's kernels (`vstrains_tpu_torch/csrc/`) and
times, with CUDA events after warm-up, the kernels this repository
redesigns at the shapes its paths give them:

  * window_hashes, split_len 56, at the paths' batches: the wire feed
    at 16,384 pairs of T = 256 (HIV dense), 32,768 pairs of T = 256 (HIV
    sparse) and 16,384 pairs of T = 150 (N = 50k), and the byte feed at
    16,384 pairs of T = 256 (HIV dense) and, for rows far wider than
    the paths', at 128 pairs of T = 30,000;
  * pair_counts at the HIV dense batch (B = 16,384, N = 773);
  * sort_rows, (key, val) and key-only, at the N = 50k sparse tail
    (32,768 x 285) and the HIV sparse tail (65,536 x 402);
  * dup_scan, where both checkouts have it: at the repeat cell's first
    batch (tools/repeat_workload, 2B = 32,768, K = 95, D = max_dup = 32,
    a 1 M-entry table that sits in L2) and at the N = 300k cell's shape
    (K = 95, D = 4) over a random sorted table of 2^27 entries (out of
    L2) whose windows are drawn from it, 10% of them misses.

Inputs are made from fixed numpy seeds, so both checkouts see the same
data. Each shape is timed with this checkout's `chip_smoke.cuda_ms` both
ways: "queued" (the runs wait behind a device sleep, so a kernel shorter
than its wrapper's host time is timed back to back) and "host-paced"
(no sleep: such a kernel is timed at the host's pace). The turns go
base, this, this, base; the result (the card's name and power limit,
every turn's times and each shape's mean per checkout) is printed as one
JSON line and written to PATH when given, with the SASS instruction
counts of each checkout's window_hashes and dup_scan kernels
(`chip_smoke.sass_summary`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CHILD = r"""
import importlib.util, json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as P

spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[2], "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
out = {}

def time_both(name, fn, iters=20):
    for _ in range(3):
        fn()
    for queue, how in ((True, "queued"), (False, "host-paced")):
        out[f"{name} | {how}"] = smoke.cuda_ms(fn, iters, queue=queue)

dev = torch.device("cuda")
rng = np.random.RandomState(0)
L = 56
for B, T in ((16384, 256), (32768, 256), (16384, 150)):
    ends = []
    read = min(T, 250)  # 250 bp reads pad to T = 256
    for _ in range(2):
        lens = np.where(rng.rand(B) < 0.9, read,
                        rng.randint(L, read + 1, B)).astype(np.int32)
        codes = rng.randint(0, 4, (B, T)).astype(np.uint8)
        codes[np.arange(T)[None, :] >= lens[:, None]] = 255
        ends += [codes, lens]
    wire = torch.from_numpy(P._pack_wire_np(*ends, T)).to(dev)
    time_both(f"window_hashes wire {B} pairs T={T}",
              lambda: ck.window_hashes_wire(wire, T, L))
    del wire
    if (B, T) == (16384, 256):
        ends[0][rng.rand(B, T) < 0.002] = 4  # in-read non-ACGT codes
        codes, lens = (torch.from_numpy(x).to(dev)
                       for x in P._stack_ends_np(*ends))
        time_both(f"window_hashes bytes {B} pairs T={T}",
                  lambda: ck.window_hashes_bytes(codes, lens, L))
        del codes, lens
# rows far wider than the paths' (long reads through the byte feed)
B, T = 128, 30000
codes = torch.from_numpy(
    rng.randint(0, 4, (2 * B, T)).astype(np.uint8)).to(dev)
lens = torch.full((2 * B,), T, dtype=torch.int32, device=dev)
time_both(f"window_hashes bytes {B} pairs T={T}",
          lambda: ck.window_hashes_bytes(codes, lens, L))
del codes, lens
B, N = 16384, 773
f, r = (torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)
        for _ in range(2))
acc = [torch.zeros((N, N), dtype=torch.int64, device=dev) for _ in range(2)]
time_both(f"pair_counts B={B} N={N}", lambda: ck.pair_counts(f, r, *acc))
for R, C in ((32768, 285), (65536, 402)):
    key = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    val = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    time_both(f"sort_rows (key, val) {R}x{C}", lambda: ck.sort_rows(key, val))
    time_both(f"sort_rows key-only {R}x{C}", lambda: ck.sort_rows(key))
del key, val
if hasattr(ck, "dup_scan"):
    from tools.repeat_workload import repeat_workload
    refs, fwd, rve, k = repeat_workload(n_pairs=16384)
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    table = P.build_kmer_table(refs, k + 1)
    args = smoke.classic_inputs(table, ReadPairBatch(fc, fl, rc, rl, 0, 0,
                                                     len(fl)), 16384, k + 1)
    R, K = args[0].shape
    time_both(f"dup_scan repeat {R}x{K} D={table.max_dup}",
              lambda: ck.dup_scan(*args, table.max_dup, table.num_nodes))
    del args
    gen = torch.Generator(device=dev).manual_seed(27)
    M, D, N = 2**27, 4, 300000
    t1, t2, tn = (torch.randint(lo_, hi_, (M,), generator=gen, device=dev,
                                dtype=torch.int32)
                  for lo_, hi_ in ((-2**31, 2**31 - 1), (-2**31, 2**31 - 1),
                                   (0, N)))
    t1 = torch.sort(t1).values
    pick = torch.randint(0, M, (R, K), generator=gen, device=dev)
    q1, h2 = t1[pick], t2[pick]
    miss = torch.rand((R, K), generator=gen, device=dev) < 0.1
    q1 = torch.where(miss, q1 ^ 0x5A5A, q1)
    valid = torch.rand((R, K), generator=gen, device=dev) < 0.97
    lo = torch.searchsorted(t1, q1.reshape(-1)).to(torch.int32).reshape(R, K)
    time_both(f"dup_scan large table {R}x{K} D={D} M=2^27",
              lambda: ck.dup_scan(q1, h2, valid, lo, t1, t2, tn, D, N))
print(json.dumps(out))
"""


def turn(root: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _CHILD, root, REPO],
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
                   for k in next(t for n, t in turns if n == name)}
            for name in roots}
    from chip_smoke import sass_summary
    sass = {}
    for name, root in roots.items():
        libs = glob.glob(os.path.join(root, "build", "vstrains_tpu_torch",
                                      "libvt_kernels_*.so"))
        lib = max(libs, key=os.path.getmtime)
        sass[name] = [line for line in sass_summary(lib)
                      if line.startswith(("sass window_hashes",
                                          "sass dup_scan"))]
    res = {"card": smi, "turns": turns, "mean_ms": mean, "sass": sass}
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
