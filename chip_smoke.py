#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`vstrains_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the script exits non-zero
without the final result line):
  1. the card (nvidia-smi name and power limit), then the build of the
     CUDA kernels from `vstrains_tpu_torch/csrc/` with nvcc, timed;
  2. the full-size HIV labmix dataset (`evals/hivsim.make_hiv_dataset`,
     seed 0: 5 strains, 773 nodes, 388,928 pairs of 250 bp), its input
     files checked against the digests the JAX package's run recorded in
     tests/data/torch_port_expected.json (generators run in a child
     process under PYTHONHASHSEED=0, as there: the HIV generator's
     contig order follows the iteration order of a set of strings);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the HIV run gives it, from numpy-seeded inputs: the outputs
     must be bit-equal (tolerance 0: every output is an integer), with
     the CUDA-event time of each after warm-up; then the same check,
     untimed, at ragged shapes;
  4. the verify-recipe synthetic dataset through the port CLI on cuda:
     the strain set must equal the planted haplotypes and the output
     files the JAX package's bytes;
  5. the HIV dataset through the port CLI on cuda (--pe-batch-size
     16384) with every kernel's launch count reset just before: outputs
     byte-equal to the JAX package's, every kernel launched, stage times,
     PE throughput and per-strain NGA50 printed.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
EXPECTED = os.path.join(REPO, "tests", "data", "torch_port_expected.json")


def say(msg: str) -> None:
    print(msg, flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_digests(kind: str, base: str, expected: dict) -> None:
    bad = {f: (sha256_file(os.path.join(base, f)), want)
           for f, want in expected.items()
           if sha256_file(os.path.join(base, f)) != want}
    if bad:
        raise AssertionError(f"{kind} digests differ from the JAX record: "
                             f"{json.dumps(bad, indent=1)}")


_GEN_CODE = """
import json, sys
import vstrains_tpu_torch.evals.{mod} as m
ds = getattr(m, sys.argv[1])(sys.argv[2], **json.loads(sys.argv[3]))
haps = ds.true_haplotypes
print(json.dumps({{"haplotypes": sorted(haps.values() if isinstance(haps, dict)
                                        else haps),
                   "stats": getattr(ds, "stats", None),
                   "n_pairs": getattr(ds, "n_pairs", None)}}))
"""


def generate(mod: str, fn: str, data_dir: str, kwargs: dict) -> dict:
    """The port's dataset generator in a child process under
    PYTHONHASHSEED=0 (the hash seed the JAX record was made with)."""
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", _GEN_CODE.format(mod=mod), fn,
                        data_dir, json.dumps(kwargs)], env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{mod}.{fn} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_cli(rec: dict, data_dir: str, out_dir: str) -> float:
    """The port CLI, in this process, as a user calls it, on cuda."""
    from vstrains_tpu_torch import cli
    argv = [a.replace("{data}", data_dir).replace("{out}", out_dir)
            for a in rec["cli"]] + ["--device", "cuda"]
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    rc = cli.main(argv)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"port CLI exited {rc}: {argv}")
    return wall


def cuda_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(name: str, got, want) -> int:
    """Largest |kernel - plain| over all outputs; raises unless 0 (every
    output is an integer, so the tolerance is 0)."""
    import torch
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from the plain "
                             f"version (max abs err {err}; tolerance 0)")
    return err


def compare(name: str, kern, plain, iters: int = 20) -> dict:
    """Bit-equality of kernel vs plain outputs, then CUDA-event times
    after warm-up, in turns plain, kernel, kernel, plain."""
    err = max_abs_err(name, kern(), plain())
    for _ in range(3):
        kern()
        plain()
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kern, iters)
    k2 = cuda_ms(kern, iters)
    p2 = cuda_ms(plain, iters)
    res = {"max_abs_err": float(err), "ms": (k1 + k2) / 2,
           "plain_ms": (p1 + p2) / 2}
    say(f"kernel {name}: bit-equal to plain; kernel {res['ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms (CUDA events, mean of "
        f"{2 * iters})")
    return res


def ragged_shapes() -> None:
    """Kernel vs plain at ragged shapes the HIV run does not reach (row
    counts off the 32-read words, nodes off the 64-node tiles, one-row
    and one-node batches, odd read widths); correctness only."""
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    n = 0
    for B, T, L in ((1, 24, 7), (33, 37, 7), (1000, 129, 56)):
        fl = rng.randint(0, T + 1, B).astype(np.int32)
        rl = rng.randint(0, T + 1, B).astype(np.int32)
        fc = rng.randint(0, 4, (B, T)).astype(np.uint8)
        rc = rng.randint(0, 4, (B, T - 2)).astype(np.uint8)
        fc[np.arange(T)[None, :] >= fl[:, None]] = 255
        rc[np.arange(T - 2)[None, :] >= rl[:, None]] = 255
        wire = torch.from_numpy(P._pack_wire_np(fc, fl, rc, rl, T)).to(dev)
        max_abs_err(f"window_hashes wire B={B} T={T} L={L}",
                    ck.window_hashes_wire(wire, T, L),
                    ck.window_hashes_plain(*ck.unpack_wire_plain(wire, T),
                                           L))
        fc[rng.rand(*fc.shape) < 0.05] = 4
        codes, lens = (torch.from_numpy(x).to(dev)
                       for x in P._stack_ends_np(fc, fl, rc, rl))
        max_abs_err(f"window_hashes bytes B={B} T={T} L={L}",
                    ck.window_hashes_bytes(codes, lens, L),
                    ck.window_hashes_plain(codes, lens, L))
        n += 2
    for R, C, D, N in ((1, 1, 1, 1), (7, 45, 3, 65), (100, 402, 2, 6144),
                       (3, 17, 16, 6145)):
        nt = rng.randint(0, N + 1, (R, C)).astype(np.int32)
        nt = torch.from_numpy(nt).to(dev)
        max_abs_err(f"stats_accum R={R} C={C} D={D} N={N}",
                    ck.stats_accum(nt, D, N), ck.stats_accum_plain(nt, D, N))
        n += 1
    for B, N in ((1, 1), (33, 65), (1000, 130), (4097, 773)):
        f, r = (torch.from_numpy((rng.rand(B, N) < 0.3).astype(np.uint8))
                .to(dev) for _ in range(2))
        acc = [torch.full((N, N), 3, dtype=torch.int64, device=dev)
               for _ in range(4)]
        ck.pair_counts(f, r, acc[0], acc[1])
        ck.pair_counts_plain(f, r, acc[2], acc[3])
        max_abs_err(f"pair_counts B={B} N={N}", acc[:2], acc[2:])
        n += 1
    say(f"ragged shapes: {n} kernel checks bit-equal to plain")


def kernel_phase(gfa_path: str) -> dict:
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    # the HIV run's shapes: 2B = 32,768 stacked reads, T = 256 (250 bp
    # padded to 32), windows of k+1, N nodes, D duplicate ranks
    seqs, overlap = [], None
    with open(gfa_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                seqs.append(f[2])
            elif f[0] == "L" and overlap is None:
                overlap = int(f[5][:-1])
    L = overlap + 1
    N = len(seqs)
    D = min(P.build_kmer_table(seqs, L).max_dup, P._SORTFILL_MAX_DUP)
    B, T = 16384, 256
    K = T - L + 1
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    say(f"kernel shapes: B={B} pairs (2B={2 * B} rows), T={T}, "
        f"split_len={L}, K={K}, N={N}, D={D}")

    fl = np.where(rng.rand(B) < 0.9, 250,
                  rng.randint(L, 251, B)).astype(np.int32)
    rl = np.where(rng.rand(B) < 0.9, 250,
                  rng.randint(L, 251, B)).astype(np.int32)
    fc = rng.randint(0, 4, (B, T)).astype(np.uint8)
    rc = rng.randint(0, 4, (B, T)).astype(np.uint8)
    cols = np.arange(T)[None, :]
    fc[cols >= fl[:, None]] = 255
    rc[cols >= rl[:, None]] = 255
    wire = torch.from_numpy(P._pack_wire_np(fc, fl, rc, rl, T)).to(dev)
    res = {}
    res["window_hashes"] = compare(
        "window_hashes (wire feed)",
        lambda: ck.window_hashes_wire(wire, T, L),
        lambda: ck.window_hashes_plain(*ck.unpack_wire_plain(wire, T), L))
    # byte feed: in-read non-ACGT codes and 255 padding
    bc = fc.copy()
    bc[rng.rand(B, T) < 0.002] = 4
    codes, lens = P._stack_ends_np(bc, fl, rc, rl)
    codes_d = torch.from_numpy(codes).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    compare("window_hashes (byte feed)",
            lambda: ck.window_hashes_bytes(codes_d, lens_d, L),
            lambda: ck.window_hashes_plain(codes_d, lens_d, L))

    def node_slots(R, C, n_nodes):
        # each read hits a few nodes; most slots miss (sentinel n_nodes)
        picks = rng.randint(0, n_nodes, (R, 3))
        which = rng.randint(0, 8, (R, C))
        nt = np.full((R, C), n_nodes, np.int32)
        for s in range(3):
            m = which == s
            nt[m] = np.broadcast_to(picks[:, s:s + 1], (R, C))[m]
        return torch.from_numpy(nt).to(dev)

    R, C = 2 * B, K * D
    nt = node_slots(R, C, N)
    if not ck.stats_accum_uses_shared(N):
        raise AssertionError(f"N={N} should take the shared-memory branch")
    res["stats_accum"] = compare(
        f"stats_accum (shared counters, R={R} C={C} N={N})",
        lambda: ck.stats_accum(nt, D, N),
        lambda: ck.stats_accum_plain(nt, D, N))
    n_big = 8192
    if ck.stats_accum_uses_shared(n_big):
        raise AssertionError(f"N={n_big} should take the global branch")
    nt_big = node_slots(R, C, n_big)
    compare(f"stats_accum (global atomics, R={R} C={C} N={n_big})",
            lambda: ck.stats_accum(nt_big, D, n_big),
            lambda: ck.stats_accum_plain(nt_big, D, n_big), iters=5)
    del nt_big

    f = torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)
    r = torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)

    def pairs(fn):
        acc = (torch.zeros((N, N), dtype=torch.int64, device=dev),
               torch.zeros((N, N), dtype=torch.int64, device=dev))
        fn(f, r, *acc)
        return acc

    res["pair_counts"] = compare(
        f"pair_counts (B={B}, N={N})",
        lambda: pairs(ck.pair_counts), lambda: pairs(ck.pair_counts_plain))
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from vstrains_tpu_torch.evals.nga50 import load_fasta, nga50_report
    from vstrains_tpu_torch.ops import _build
    from vstrains_tpu_torch.ops import cuda_kernels as ck

    with open(EXPECTED) as fh:
        expected = json.load(fh)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # 1. build
    info = _build.build()
    _build.load()
    say(f"build: {'compiled' if info['built'] else 'cached'} "
        f"{os.path.relpath(info['path'], REPO)} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # 2. HIV dataset
    hiv = expected["hiv"]
    hiv_data = os.path.join(WORK, "hiv_data")
    t0 = time.time()
    ds = generate("hivsim", "make_hiv_dataset", hiv_data,
                  hiv["generator"]["kwargs"])
    check_digests("HIV input", hiv_data, hiv["inputs"])
    say(f"hiv dataset: {ds['stats']['num_nodes']} nodes, {ds['n_pairs']} "
        f"pairs, generated in {time.time() - t0:.1f} s; input digests "
        "match")

    # 3. kernels vs plain versions
    kres = kernel_phase(os.path.join(
        hiv_data, "assembly_graph_after_simplification.gfa"))
    ragged_shapes()

    # 4. synth slice
    syn = expected["synth"]
    syn_data = os.path.join(WORK, "synth_data")
    sds = generate("synth", "make_dataset", syn_data,
                   syn["generator"]["kwargs"])
    check_digests("synth input", syn_data, syn["inputs"])
    syn_out = os.path.join(WORK, "synth_out")
    wall = run_cli(syn, syn_data, syn_out)
    strains = set(load_fasta(os.path.join(syn_out, "strain.fasta"))
                  .values())
    if strains != set(sds["haplotypes"]):
        raise AssertionError("synth: strain set differs from the planted "
                             "haplotypes")
    check_digests("synth output", syn_out, syn["outputs"])
    say(f"synth: {len(strains)} strains = planted haplotypes; outputs "
        f"byte-equal to the JAX record ({wall:.1f} s)")

    # 5. HIV slice: the main path, counted
    hiv_out = os.path.join(WORK, "hiv_out")
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    wall = run_cli(hiv, hiv_data, hiv_out)
    launches = dict(ck.LAUNCHES)
    say(f"hiv: port CLI {wall:.2f} s; kernel launches {launches}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
        "MiB")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    check_digests("HIV output", hiv_out, hiv["outputs"])
    with open(os.path.join(hiv_out, "timings.json")) as fh:
        timings = json.load(fh)
    stages = {s["stage"]: s["seconds"] for s in timings["stages"]}
    used = None
    with open(os.path.join(hiv_out, "vstrains.log")) as fh:
        for line in fh:
            if "reads: used=" in line:
                used = int(line.split("used=")[1].split(",")[0])
    say(f"hiv stages (s): {json.dumps(stages)}")
    say(f"hiv PE stage: {used} read pairs in {stages['pe_inference']:.3f} s"
        f" = {used / stages['pe_inference']:.1f} reads/s (pairs per "
        "second, FASTQ load and table build included)")
    rep = nga50_report(load_fasta(os.path.join(hiv_out, "strain.fasta")),
                       load_fasta(os.path.join(hiv_data,
                                               "true_strains.fasta")),
                       k=31, min_block=500)
    rep.pop("_aggregate")
    nga = {r: v["nga50"] for r, v in sorted(rep.items())}
    if nga != hiv["nga50"]:
        raise AssertionError(f"NGA50 {nga} != JAX record {hiv['nga50']}")
    say(f"hiv: outputs byte-equal to the JAX record; NGA50 per strain "
        f"{json.dumps(nga)}")

    kernels = []
    for meta in ck.KERNELS:
        m = kres[meta["name"]]
        kernels.append(dict(meta, launches=launches[meta["name"]],
                            max_abs_err=m["max_abs_err"], ms=m["ms"],
                            plain_ms=m["plain_ms"]))
    shutil.rmtree(WORK, ignore_errors=True)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
