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
    (32,768 x 285) and the HIV sparse tail (65,536 x 402); and past
    1,024 slots: 8,192 x 1,025, 2,049 and 3,216 (a HIV cap retry; 2, 4
    and 8 warps a row in both checkouts' network), then where a checkout
    with csrc/sort_net.cuh sorts a row in one block up to 16,384 slots
    and the parent took its global branch, 2,048 x 4,097, 4,096 x 6,080
    (the repeat64 sparse tail) and 2,048 x 10,000, and 256 x 40,000 (the
    global branch in both);
  * the column sort of 2,048 x 2,048: sort_cols where the checkout has
    it, else sort_rows key-only on the transpose (the parent's route,
    transposes included);
  * the classic probe's walk, where both checkouts have dup_scan: the
    dense engine's stats (a checkout with dup_stats runs it; one without
    runs dup_scan's slot plane through stats_accum) at the repeat cell's
    first batch (tools/repeat_workload, 2B = 32,768, K = 95, D = max_dup
    = 32, N = 1,024, a 1 M-entry table that sits in L2) and at the HIV
    classic modes' shape (2B = 32,768, K = 201, D = 2, N = 773; a
    synthetic table of 100,000 entries padded to 2^17, runs of one or two
    entries); and the sparse engine's (node, window) planes (dup_scan,
    or the old dup_scan plus the torch passes that built the planes from
    its slots) at the repeat cell's sparse batch (2B = 8,192) and at the
    N = 300k cell's shape (K = 95, D = 4) over a random sorted table of
    2^27 entries (out of L2) whose windows are drawn from it, 10% of them
    misses. A checkout with dup_stats reads the table as the interleaved
    [M, 4] record, the parent as three arrays.

Inputs are made from fixed numpy seeds, so both checkouts see the same
data. Each shape is timed with this checkout's `chip_smoke.cuda_ms` both
ways: "queued" (the runs wait behind a device sleep, so a kernel shorter
than its wrapper's host time is timed back to back) and "host-paced"
(no sleep: such a kernel is timed at the host's pace). The turns go
base, this, this, base; the result (the card's name and power limit,
every turn's times and each shape's mean per checkout) is printed as one
JSON line and written to PATH when given, with the SASS instruction
counts of each checkout's window_hashes, classic-probe and sort kernels
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
for R, C, forms in ((8192, 1025, 2), (8192, 2049, 2), (8192, 3216, 2),
                      (2048, 4097, 2), (4096, 6080, 2), (2048, 10000, 2),
                      (256, 40000, 2)):
    key = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    val = torch.from_numpy(rng.randint(-2**31, 2**31, (R, C))
                           .astype(np.int32)).to(dev)
    time_both(f"sort_rows (key, val) {R}x{C}", lambda: ck.sort_rows(key, val),
              iters=10)
    if forms == 2:
        time_both(f"sort_rows key-only {R}x{C}", lambda: ck.sort_rows(key),
                  iters=10)
del key, val
x = torch.from_numpy(rng.randint(-2**31, 2**31, (2048, 2048))
                     .astype(np.int32)).to(dev)
if hasattr(ck, "sort_cols"):
    time_both("column sort 2048x2048", lambda: ck.sort_cols(x))
else:
    time_both("column sort 2048x2048",
              lambda: ck.sort_rows(x.T.contiguous()).T)
del x
# the classic probe's walk: the parent's dup_scan slot plane, read by
# stats_accum (dense) or turned into the sparse tail's planes by torch
# passes, against this checkout's dup_stats / dup_scan; both checkouts see
# the same windows (hashed by their own window_hashes, lo from one binary
# search) and the same table
fused = hasattr(ck, "dup_stats")

def table_of(h1, h2, node):
    return ((h1, h2, node),
            torch.stack([h1, h2, node, torch.zeros_like(h1)], dim=1))

def classic_stats(win, arrays, rec, D, N):
    if fused:
        return lambda: ck.dup_stats(*win, rec, D, N)
    return lambda: ck.stats_accum(ck.dup_scan(*win, *arrays, D, N), D, N)

def classic_planes(win, table, D, N):
    if fused:
        return lambda: ck.dup_scan(*win, table, D)
    def run():
        node_t = ck.dup_scan(*win, *table, D, N)
        B2, C = node_t.shape
        matched = node_t < N
        kidx = (torch.arange(C, dtype=torch.int32, device=dev)
                // D).expand(B2, C)
        return (torch.where(matched, node_t, 2**31 - 1),
                torch.where(matched, kidx, 2**31 - 1))
    return run

def windows(q1, h2, valid, h1):
    lo = torch.searchsorted(h1, q1.reshape(-1)).to(torch.int32)
    return (q1, h2, valid, lo.reshape(q1.shape))

if hasattr(ck, "dup_scan"):
    from tools.repeat_workload import repeat_workload
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    refs, fwd, rve, k = repeat_workload(n_pairs=16384)
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    table = P._build_kmer_table(refs, k + 1, True, None)
    D, N = table.max_dup, table.num_nodes
    arrays, rec = table_of(*(torch.from_numpy(a).to(dev) for a in
                             (table.h1_biased, table.h2, table.node)))
    for pairs in (16384, 4096):
        codes, lens = (torch.from_numpy(x).to(dev) for x in P._stack_ends_np(
            fc[:pairs], fl[:pairs], rc[:pairs], rl[:pairs]))
        win = windows(*ck.window_hashes_bytes(codes, lens, k + 1), arrays[0])
        R, K = win[0].shape
        if pairs == 16384:
            time_both(f"classic stats, repeat {R}x{K} D={D} N={N}",
                      classic_stats(win, arrays, rec, D, N))
        else:
            time_both(f"classic sparse planes, repeat {R}x{K} D={D}",
                      classic_planes(win, rec if fused else arrays, D, N))
    del win, arrays, rec
    # the HIV classic modes' shape (2B = 32,768, K = 201, N = 773, runs of
    # at most 2): a synthetic table of 100,000 entries padded to 2^17,
    # windows drawn from it, 10% of them misses
    gen = torch.Generator(device=dev).manual_seed(2)
    M, m_real, N, D, R, K = 2**17, 100000, 773, 2, 32768, 201
    h1 = torch.sort(torch.randint(-2**31, 2**31 - 1, (m_real,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)).values
    dup = torch.rand(m_real, generator=gen, device=dev) < 0.3
    dup[0] = False
    h1 = torch.where(dup, torch.roll(h1, 1), h1)  # runs of one or two
    h1 = torch.cat([h1, torch.full((M - m_real,), 2**31 - 1, device=dev,
                                   dtype=torch.int32)])
    h2 = torch.randint(-2**31, 2**31 - 1, (M,), generator=gen, device=dev,
                       dtype=torch.int32)
    node = torch.randint(0, N, (M,), generator=gen, device=dev,
                         dtype=torch.int32)
    arrays, rec = table_of(h1, h2, node)
    pick = torch.randint(0, m_real, (R, K), generator=gen, device=dev)
    miss = torch.rand((R, K), generator=gen, device=dev) < 0.1
    q1 = torch.where(miss, h1[pick] ^ 0x5A5A, h1[pick])
    valid = torch.rand((R, K), generator=gen, device=dev) < 0.97
    win = windows(q1, h2[pick], valid, h1)
    time_both(f"classic stats, HIV-shaped {R}x{K} D={D} N={N}",
              classic_stats(win, arrays, rec, D, N))
    del win, arrays, rec
    # the N = 300k cell's shape (K = 95, D = 4) over a random sorted table
    # of 2^27 entries (out of L2), windows drawn from it, 10% misses
    gen = torch.Generator(device=dev).manual_seed(27)
    M, D, N, R, K = 2**27, 4, 300000, 32768, 95
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
    win = windows(q1, h2, valid, t1)
    arrays, rec = table_of(t1, t2, tn)
    time_both(f"classic sparse planes, large table {R}x{K} D={D} M=2^27",
              classic_planes(win, rec if fused else arrays, D, N))
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
                                          "sass dup_", "sass sort_"))]
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
