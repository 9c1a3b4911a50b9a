#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`vstrains_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --pinned-drain     # phase 5a alone
    python3 chip_smoke.py --coo-accum        # phase 6a alone
    python3 chip_smoke.py --card-table       # phase 5c alone

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
     the CUDA-event time of each after warm-up beside its bound (the
     H100's published memory or int8 rate) and, where one PyTorch call
     computes the same function, that call's time; pair_counts also on
     all-ones masks; sort_rows on both sides of its one-block network's
     limit (4,097 and 10,000 slots in the network, 40,000 in the global
     branch) and sort_cols (no path calls it) at 2,048 x 2,048 and 3,000 x
     1,001; then the same check, untimed, at ragged shapes (for
     dup_stats and dup_scan: synthetic padded tables with duplicate runs,
     scans that start at or just before the table's end, queries equal to
     the padding, all-invalid rows, D up to 300, K past a block's
     threads, N past the shared counters);
  4. the verify-recipe synthetic dataset through the port CLI on cuda:
     the strain set must equal the planted haplotypes and the output
     files the JAX package's bytes;
  5. the HIV dataset through the port CLI on cuda (--pe-batch-size
     16384, the dense PE engine) with every kernel's launch count reset
     just before: outputs byte-equal to the JAX package's, the dense
     engine's kernels launched, stage times, PE throughput and per-strain
     NGA50 printed, and the "sort" engine wall from the run's log; then
     that run's graph (gfa/s_graph_L1.gfa) and reads through
     `infer_pe_links` in each classic probe mode ("sortjoin", "lookup",
     "searchsorted"), three rounds of the three: dup_stats launched in
     place of stats_accum, the first round's write_pe_files byte-equal
     to the HIV record's aln files, every run's engine wall and the first
     round's peak memory printed, then the device table (built on the
     card) timed alone; dup_stats at the HIV shapes (K = 201, D = 1,
     max_dup, 32); the graph passes on
     the card (graph_is_dag_device against the host DFS before and after
     one back edge; edge_flow_device on 20,000 edges against the float64
     host path, rtol 1e-6);
 5a. the dense engine's drain into page-locked host memory, on 400
     random nodes: the CUDA engine's node_mat and short_mat page-locked
     and equal to the CPU engine's, a second call's arrays in the blocks
     the first call's left, `pe.d2h_pinned_bytes` equal to
     `pe.d2h_bytes` less the table build's 16-byte readback; the drain
     of two int64 [3,056, 3,056] accumulators
     timed against the pageable copies it replaced;
 5c. the PE k-mer table built on the card (`pe_infer._card_table`, the
     payloads and record in `_device_table`) on the graphs of an
     hiv_labmix, a zikv15 and an hcmv3 dataset from `portbench/gen`
     (generator seeds 0, 1, 1; no reads): bit-equal to the host build
     (C++ path, host payloads) in every entry array with its padding,
     max_dup, the entry count, the payloads, the record and the bucket
     index; each route timed, the card's by CUDA events and by host wall
     with the readback and the encode, beside the host's wall;
  6. the same HIV dataset through the port CLI with --pe-batch-size
     262144, which the dense/sparse memory rule routes to the sparse PE
     engine: outputs byte-equal to the same JAX record (the two engines
     give identical links), window_hashes and sort_rows launched,
     stats_accum and pair_counts not; then window_hashes and sort_rows
     against their plain versions at the shapes that run gave them (its
     batch and depth read from its log, its first batch of reads);
 6a. the sparse engine's link keys counted on the card (`coo_accum`,
     csrc/coo_accum.cu): kernel and the driver's finish against the
     plain version (the host COO) on a cut hcmv3 run's lists (also
     across a rehash) and on synthetic skewed lists at 2B = 32,768 x cap
     16; the engine on that dataset against the benchmark's plain
     reference at the tables' first size and from 4,096 slots (growth
     forced); each batch shape timed beside its bound (distinct keys at
     the card's measured L2 atomic rate) and the plain version's time;
  7. the N = 50,000 cell (`bench.synth_workload`, 50,000 nodes of 200 bp,
     1,048,576 pairs of 150 bp, seed 0) through the engine entry point
     `infer_pe_links(stats_mode="auto")`: a checked run on the first
     262,144 pairs whose `write_pe_files_sparse` files must equal the JAX
     package's digests (it is also the warm-up); window_hashes and
     sort_rows against their plain versions at that run's shapes, as in
     6; then the timed run on all 1,048,576 pairs;
  8. the repeat cell (`tools/repeat_workload.repeat_workload`, seed 5:
     1,024 nodes of 400 bp in 32 groups sharing an 80-bp motif, max_dup
     32, so the classic join; 262,144 pairs of 150 bp) through
     infer_pe_links dense and sparse, both write_pe_files outputs equal to
     the JAX record "repeat"; dup_stats at the dense run's shape (2B =
     32,768, K = 95, D = 32, N = 1,024) and dup_scan at the sparse run's
     (2B = 8,192), the kernels line's main shapes for both, with
     stats_accum at the slot plane dup_stats replaces;
  8b. the repeat64 cell (the same generator with 16 groups of 64 nodes:
     max_dup 64, so the sparse tail's rows of 95 x 64 = 6,080 slots pad
     to 8,192 and sort in sort_rows' one-block network, which the run must
     show by its launches' padded widths) through infer_pe_links dense
     (dup_stats at depth 64) and sparse: 65,536 pairs each against the
     JAX record "repeat64", then each timed on 262,144 pairs; the path's
     kernels at its shapes;
  9. the N = 300,000 cell (`bench.synth_workload`, 300,000 nodes of 200
     bp, past the packed probe's 2^18 node ids: the sparse engine and the
     classic join; 1,048,576 pairs, seed 0): host seconds of each set-up
     step, a checked run of 65,536 pairs against the JAX record "r300k",
     window_hashes, dup_scan and sort_rows at that run's shapes, then the
     timed run on every pair;
 10. BASELINE config 5, the 15-strain metaviral sample
     (`evals/synth.make_multi_component_dataset`: 3 components x 5
     strains, seed 3), through the port CLI on cuda with --per-component
     and --component-workers 1 and 2 (spawned workers): outputs
     byte-equal to the JAX record "metaviral", all 15 haplotypes
     recovered, the wall printed;
 11. `parallel.mesh.infer_pe_links_sharded` on the HIV graph and reads in
     a torch.distributed world of one rank over NCCL: write_pe_files
     byte-equal to the HIV record;
 12. two ranks spawned on cuda:0 over gloo (`--rank`), at (data, model)
     = (2, 1) and (1, 2) in turn: the HIV dense engine (packed probe,
     stats_accum on each shard), the repeat cell dense (dup_stats on
     each shard) and sparse (dup_scan, sort_rows in the TP merge), and
     the N = 50k cell's checked 262,144 pairs (sparse, sort_rows): every
     rank's files byte-equal to the JAX records "hiv", "repeat" and
     "r50k";
 13. on the same two ranks, `parallel.distributed.
     infer_pe_links_multihost` on HIV stripes and --per-component on
     the metaviral sample (components round-robin over the ranks),
     against the same records;
 14. `sp_window_hashes` over the two ranks on a 100 kb seeded sequence
     against the host hashes, and window_hashes_bytes against its plain
     version at one rank's block shape, timed; and
     `parallel.mesh.build_table_auto` over the two ranks (its 16 nodes
     of 8-60 kb hashed sequence-parallel, 2,000 nodes of 200-2,000 bp
     by the host C++ build) against the host C++ build alone: the same
     table, both walls printed.
     Each rank prints its launch counts and wall a job (pair_counts only
     on model rank 0) and replays every kernel call of each job, at each
     shape its shard gave the kernel, against the plain version
     (bit-equal). Two ranks on one card check correctness and the
     shards' kernel shapes, not scaling; no run here has two cards.
 15. the kernel warm-up layer, each in a fresh process: `python -m
     vstrains_tpu_torch.prewarm` on HIV at batch 16,384 (exit 0; its
     nodes, k and widths those of the phase-5 run's log and batches;
     window_hashes, stats_accum and pair_counts launched at each width;
     its record printed); then the HIV CLI with `_build.BUILD_DIR` set to
     an empty directory (a cold nvcc build on the pipeline's background
     thread) and once more on the library it built: outputs byte-equal
     to the JAX record both times, the build's seconds by source,
     pe_inference and the PE stage's wait at the join printed beside
     phase 5's.
dup_stats and dup_scan are timed beside a bound that counts each table
entry their walks examine once (dup_table_bytes), printed.
The build (phase 1) also prints each source's nvcc seconds, ptxas's
registers and spills per kernel and, from cuobjdump, the instruction
counts that show the redesigned kernels' designs. Every run above resets
the launch counts just before and checks just after that its path's
kernels launched and no other path's did. The line before the last is a
JSON object with each kernel's launches (each from the run of the path it
belongs to), error, times, bound and library call, and its other checked
shapes; the last line is {"ok": true, "device": {...}}.
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


def run_cli(rec: dict, data_dir: str, out_dir: str,
            pe_batch: int = None, extra=()) -> float:
    """The port CLI, in this process, as a user calls it, on cuda."""
    from vstrains_tpu_torch import cli
    argv = [a.replace("{data}", data_dir).replace("{out}", out_dir)
            for a in rec["cli"]] + ["--device", "cuda", *extra]
    if pe_batch is not None:
        argv[argv.index("--pe-batch-size") + 1] = str(pe_batch)
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    rc = cli.main(argv)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"port CLI exited {rc}: {argv}")
    return wall


# device cycles (~11 ms) the stream sleeps before a timed run, while the
# host queues the run's launches, so that a kernel shorter than its
# wrapper's host time is timed back to back and not at the host's pace
QUEUE_CYCLES = 20_000_000


def cuda_ms(fn, iters: int, queue: bool = True) -> float:
    """Mean device time of `iters` calls between two CUDA events. With
    `queue` the runs wait behind a device sleep of QUEUE_CYCLES and so
    run back to back; without it a call shorter than its own host time
    is timed at the host's pace."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue:
        torch.cuda._sleep(QUEUE_CYCLES)
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
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
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


# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM3 bytes/s
# and dense int8 tensor-core operations/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def bound(nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the int8
    operations at the tensor cores' rate, whichever is longer."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = int8_ops / INT8_OPS_S * 1e3
    if by_ops > by_bytes:
        return {"bound_ms": by_ops, "bound_by": "operations",
                "bound_rate": "1,979 TOP/s int8 tensor cores"}
    return {"bound_ms": by_bytes, "bound_by": "bytes",
            "bound_rate": "3.35 TB/s HBM3"}


def compare(name: str, kern, plain, iters: int = 20, bound_: dict = None,
            library=None) -> dict:
    """Bit-equality of kernel vs plain outputs, then CUDA-event times
    after warm-up, in turns plain, kernel, kernel, plain, library.
    `library` is a list of (label, call) computing the same function in
    one PyTorch call (timed only, never on the port's path) or a string
    saying why there is none; the fastest call gives library_ms."""
    err = max_abs_err(name, kern(), plain())
    calls = library if isinstance(library, list) else []
    for _ in range(3):
        kern()
        plain()
        for _, call in calls:
            call()
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kern, iters)
    k2 = cuda_ms(kern, iters)
    p2 = cuda_ms(plain, iters)
    lib = {label: cuda_ms(call, iters) for label, call in calls}
    res = {"max_abs_err": float(err), "ms": (k1 + k2) / 2,
           "plain_ms": (p1 + p2) / 2, "library_ms": None,
           "library": library if isinstance(library, str) else None}
    if lib:
        best = min(lib, key=lib.get)
        res.update(library_ms=lib[best], library=best)
    res.update(bound_ or {})
    text = (f"kernel {name}: bit-equal to plain; kernel {res['ms']:.4f} ms, "
            f"plain {res['plain_ms']:.4f} ms")
    for label, ms in lib.items():
        text += f", {label} {ms:.4f} ms"
    if bound_:
        text += (f"; bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
                 f"{100 * res['bound_ms'] / res['ms']:.1f}% of it")
    say(text + f" (CUDA events, mean of {2 * iters})")
    return res


def sort_bound(key, val) -> dict:
    """Each int32 slot read once and written once, key and value."""
    return bound(2 * key.numel() * 4 * (1 if val is None else 2))


def sort_library(key, val) -> list:
    """torch.sort over the same rows: of the keys, or of the packed
    int64 word (key << 32) + (val + 2^31), packing excluded."""
    import torch
    if val is None:
        return [("torch.sort(key, dim=1)", lambda: torch.sort(key, dim=1))]
    w = (key.to(torch.int64) << 32) + (val.to(torch.int64) + 2**31)
    return [("torch.sort(packed int64, dim=1)", lambda: torch.sort(w, dim=1))]


def hash_bound(in_bytes: int, rows: int, K: int) -> dict:
    """The feed read once; q1, h2 (int32) and valid (uint8) written."""
    return bound(in_bytes + rows * K * 9)


NO_LIBRARY_HASH = ("none: no PyTorch call computes the fused unpack and "
                   "the two rolling window hashes")
NO_LIBRARY_STATS = ("none: the plain version is two scatters (count and "
                    "min), no single PyTorch call")


def ragged_shapes() -> None:
    """Kernel vs plain at ragged shapes the HIV run does not reach (row
    counts off the 32-read words, nodes off the 128-node tiles, one-row
    and one-node batches, odd read widths); correctness only."""
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    n = 0
    # (1, 320, 128): SPAdes k = 127 on 2 x 300 bp reads, windows far longer
    # than a lane's run; (40, 24, 7): K = 18 < 32 lanes; 4099 pairs: 8,198
    # rows, not a whole number of the kernel's blocks; T = 700: a row
    # alone in its warp; T = 30,000: rows cut into chunks of windows;
    # T = 70,000 (byte feed only: the wire's lengths are u16)
    for B, T, L in ((1, 24, 7), (33, 37, 7), (1000, 129, 56), (1, 320, 128),
                    (40, 24, 7), (4099, 256, 56), (5, 700, 56),
                    (3, 30000, 56), (2, 70000, 56)):
        fl = rng.randint(0, T + 1, B).astype(np.int32)
        rl = rng.randint(0, T + 1, B).astype(np.int32)
        fl[0] = T
        fc = rng.randint(0, 4, (B, T)).astype(np.uint8)
        rc = rng.randint(0, 4, (B, T - 2)).astype(np.uint8)
        fc[np.arange(T)[None, :] >= fl[:, None]] = 255
        rc[np.arange(T - 2)[None, :] >= rl[:, None]] = 255
        if T < 2**16:
            wire = torch.from_numpy(P._pack_wire_np(fc, fl, rc, rl, T)).to(
                dev)
            max_abs_err(f"window_hashes wire B={B} T={T} L={L}",
                        ck.window_hashes_wire(wire, T, L),
                        ck.window_hashes_plain(
                            *ck.unpack_wire_plain(wire, T), L))
            n += 1
        fc[rng.rand(*fc.shape) < 0.05] = 4
        codes, lens = (torch.from_numpy(x).to(dev)
                       for x in P._stack_ends_np(fc, fl, rc, rl))
        max_abs_err(f"window_hashes bytes B={B} T={T} L={L}",
                    ck.window_hashes_bytes(codes, lens, L),
                    ck.window_hashes_plain(codes, lens, L))
        n += 1
    for R, C, D, N in ((1, 1, 1, 1), (7, 45, 3, 65), (100, 402, 2, 6144),
                       (3, 17, 16, 6145)):
        nt = rng.randint(0, N + 1, (R, C)).astype(np.int32)
        nt = torch.from_numpy(nt).to(dev)
        max_abs_err(f"stats_accum R={R} C={C} D={D} N={N}",
                    ck.stats_accum(nt, D, N), ck.stats_accum_plain(nt, D, N))
        n += 1
    # N = 30,000: past one packing slice of nodes (a small read set of a
    # large graph that takes the dense engine); its four accumulators
    # hold 29 GB
    for B, N in ((1, 1), (33, 65), (1000, 130), (4097, 773), (64, 30000)):
        f, r = (torch.from_numpy((rng.rand(B, N) < 0.3).astype(np.uint8))
                .to(dev) for _ in range(2))
        acc = [torch.full((N, N), 3, dtype=torch.int64, device=dev)
               for _ in range(4)]
        ck.pair_counts(f, r, acc[0], acc[1])
        ck.pair_counts_plain(f, r, acc[2], acc[3])
        max_abs_err(f"pair_counts B={B} N={N}", acc[:2], acc[2:])
        del acc
        n += 1
    torch.cuda.empty_cache()
    for R in (1, 37):
        for C in (1, 5, 31, 32, 33, 100, 285, 402, 512, 513, 1025, 2049,
                  4096, 4097, 6080, 8193, 16384, 16385, 70000):
            key, val = sort_operands(rng, R, C)
            max_abs_err(f"sort_rows R={R} C={C}", ck.sort_rows(key, val),
                        ck.sort_rows_plain(key, val))
            max_abs_err(f"sort_rows key-only R={R} C={C}",
                        [ck.sort_rows(key)], [ck.sort_rows_plain(key)])
            n += 2
    # one to 32 columns a block, ragged last blocks, lengths that are not
    # a power of two, up to the limit
    for L, W in ((1, 1), (5, 3), (33, 40), (300, 37), (512, 33), (1000, 17),
                 (2047, 4099), (5000, 3), (10000, 1), (16384, 3)):
        x = sort_operands(rng, L, W)[0]
        max_abs_err(f"sort_cols L={L} W={W}", [ck.sort_cols(x)],
                    [ck.sort_cols_plain(x)])
        n += 1
    say(f"ragged shapes: {n} kernel checks bit-equal to plain")


def sort_operands(rng, R: int, C: int):
    """int32 (key, val) on the card over the whole signed range, with
    repeated keys and INT32_MAX keys and values (which must sort before
    the kernel's padding)."""
    import numpy as np
    import torch
    key = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    key[rng.rand(R, C) < 0.3] = 2**31 - 1
    key[rng.rand(R, C) < 0.1] = -3
    val = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    val[rng.rand(R, C) < 0.1] = 2**31 - 1
    return (torch.from_numpy(key).cuda(), torch.from_numpy(val).cuda())


def sort_rows_phase(rng) -> list:
    """sort_rows against its plain version on both sides of the one-block
    network's limit (SORT_NET_MAX slots): the widest row a cap retry
    reaches on HIV, rows of 4,097 and 10,000 slots (8,192 and 16,384
    padded: 16 and 32 warps a row), and 40,000 slots (the global branch),
    (key, val) and key-only; then sort_cols against its plain version at
    2,048 x 2,048 and a ragged 3,000 x 1,001. The sparse tail's own shapes
    are checked where each sparse path runs (sparse_path_kernels). Returns
    the comparisons."""
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    out = []
    for R, C, what, forms in ((8192, 201 * 16, "HIV cap retry, D=16", 1),
                              (2048, 4097, "past 4,096 slots", 2),
                              (2048, 10000, "past 8,192 slots", 2),
                              (256, 40000, "past the network's limit", 2)):
        key, val = sort_operands(rng, R, C)
        branch = "network" if ck.sort_rows_uses_network(C) else "global"
        if (branch == "network") != (C <= ck.SORT_NET_MAX):
            raise AssertionError(f"sort_rows C={C} took the {branch} branch")
        for v in (val, None)[:forms]:
            form = "(key, val)" if v is not None else "key-only"
            shape = f"{what}, {branch} branch, {form}, R={R} C={C}"
            out.append(dict(compare(
                f"sort_rows ({shape})", lambda v=v: ck.sort_rows(key, v),
                lambda v=v: ck.sort_rows_plain(key, v), iters=10,
                bound_=sort_bound(key, v), library=sort_library(key, v)),
                kernel="sort_rows", shape=shape))
    x_rng = np.random.RandomState(5)
    for L, W in ((2048, 2048), (3000, 1001)):
        x = torch.from_numpy(x_rng.randint(-2**31, 2**31, (L, W))
                             .astype(np.int32)).cuda()
        shape = f"L={L} W={W}"
        out.append(dict(compare(
            f"sort_cols ({shape})", lambda x=x: ck.sort_cols(x),
            lambda x=x: ck.sort_cols_plain(x), iters=10,
            bound_=sort_bound(x, None),
            library=[("torch.sort(x, dim=0)",
                      lambda x=x: torch.sort(x, dim=0))]),
            kernel="sort_cols", shape=shape))
    return out


def read_gfa(gfa_path: str):
    """The graph's segment sequences and the PE windows' length (the
    overlap k plus one)."""
    seqs, overlap = [], None
    with open(gfa_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                seqs.append(f[2])
            elif f[0] == "L" and overlap is None:
                overlap = int(f[5][:-1])
    return seqs, overlap + 1


def kernel_phase(gfa_path: str) -> dict:
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    # the HIV run's shapes: 2B = 32,768 stacked reads, T = 256 (250 bp
    # padded to 32), windows of k+1, N nodes, D duplicate ranks
    seqs, L = read_gfa(gfa_path)
    N = len(seqs)
    D = min(P._build_kmer_table(seqs, L).max_dup, P._SORTFILL_MAX_DUP)
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
    res["window_hashes"] = dict(compare(
        f"window_hashes (wire feed, 2B={2 * B} T={T})",
        lambda: ck.window_hashes_wire(wire, T, L),
        lambda: ck.window_hashes_plain(*ck.unpack_wire_plain(wire, T), L),
        bound_=hash_bound(wire.numel(), 2 * B, K), library=NO_LIBRARY_HASH),
        shape=f"HIV dense, wire feed, 2B={2 * B} T={T}")
    # byte feed: in-read non-ACGT codes and 255 padding
    bc = fc.copy()
    bc[rng.rand(B, T) < 0.002] = 4
    codes, lens = P._stack_ends_np(bc, fl, rc, rl)
    codes_d = torch.from_numpy(codes).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    res["also"] = [dict(compare(
        f"window_hashes (byte feed, 2B={2 * B} T={T})",
        lambda: ck.window_hashes_bytes(codes_d, lens_d, L),
        lambda: ck.window_hashes_plain(codes_d, lens_d, L),
        bound_=hash_bound(codes_d.numel() + 4 * lens_d.numel(), 2 * B, K),
        library=NO_LIBRARY_HASH), kernel="window_hashes",
        shape=f"byte feed, 2B={2 * B} T={T}")]

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
    res["stats_accum"] = dict(compare(
        f"stats_accum (shared counters, R={R} C={C} N={N})",
        lambda: ck.stats_accum(nt, D, N),
        lambda: ck.stats_accum_plain(nt, D, N),
        bound_=bound(4 * R * C + 8 * R * N), library=NO_LIBRARY_STATS),
        shape=f"HIV dense, R={R} C={C} N={N}, shared")
    n_big = 8192
    if ck.stats_accum_uses_shared(n_big):
        raise AssertionError(f"N={n_big} should take the global branch")
    nt_big = node_slots(R, C, n_big)
    res["also"].append(dict(compare(
        f"stats_accum (global atomics, R={R} C={C} N={n_big})",
        lambda: ck.stats_accum(nt_big, D, n_big),
        lambda: ck.stats_accum_plain(nt_big, D, n_big), iters=5,
        bound_=bound(4 * R * C + 8 * R * n_big), library=NO_LIBRARY_STATS),
        kernel="stats_accum", shape=f"R={R} C={C} N={n_big}, global"))
    del nt_big

    f = torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)
    r = torch.from_numpy((rng.rand(B, N) < 0.004).astype(np.uint8)).to(dev)
    res["pair_counts"] = dict(compare(
        f"pair_counts (B={B}, N={N})", *pair_calls(f, r),
        bound_=bound(2 * B * N + 2 * 2 * 8 * N * N,
                     2 * B * N * N + 2 * B * N * (N + 1)),
        library=pair_library(f, r)), shape=f"HIV dense, B={B} N={N}")
    # all ones: every acc_nm cell counts B, every upper acc_sm cell 2B
    ones = torch.ones((B, N), dtype=torch.uint8, device=dev)
    acc = [torch.zeros((N, N), dtype=torch.int64, device=dev)
           for _ in range(2)]
    ck.pair_counts(ones, ones, *acc)
    max_abs_err(f"pair_counts all-ones (B={B}, N={N})", acc,
                [torch.full((N, N), B, dtype=torch.int64, device=dev),
                 torch.triu(torch.full((N, N), 2 * B, dtype=torch.int64,
                                       device=dev))])
    say(f"pair_counts all-ones (B={B}, N={N}): every cell exact")
    res["also"] += sort_rows_phase(rng)
    return res


def pair_calls(f, r):
    """The kernel and the plain version adding into accumulators of their
    own, zeroed here once: the first calls (the bit-equality check) see
    zeros, the timed calls add on."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    N = f.shape[1]
    accs = [torch.zeros((N, N), dtype=torch.int64, device=f.device)
            for _ in range(4)]

    def kern():
        ck.pair_counts(f, r, accs[0], accs[1])
        return accs[:2]

    def plain():
        ck.pair_counts_plain(f, r, accs[2], accs[3])
        return accs[2:]
    return kern, plain


def pair_library(f, r) -> list:
    """All three products are blocks of the Gram matrix of X = [f r]
    (B x 2N, padded to a multiple of 8 columns): torch._int_mm in int8,
    and torch.mm in bf16 with fp32 output and full-precision reduction
    (exact: 0/1 products, sums <= 2B < 2^24). _int_mm is timed with each
    operand row-major or column-major: cuBLASLt's int8 tensor-core
    kernels take only its TN layout (second operand column-major, first
    row-major), and the fastest layout counts. Each call is checked to
    give the plain version's counts before it is timed."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    B, N = f.shape
    X = torch.zeros((B, -(-2 * N // 8) * 8), dtype=torch.int8,
                    device=f.device)
    X[:, :N] = f
    X[:, N:2 * N] = r
    XT = X.T.contiguous()
    Xb = X.to(torch.bfloat16)
    XbT = Xb.T.contiguous()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # (first, second) operand of [f r]^T [f r], row- or column-major, by
    # cuBLASLt's name for the layout
    layouts = {"NN": (XT, X), "TN": (XT, XT.t()), "NT": (X.t(), X),
               "TT": (X.t(), XT.t())}
    calls = [(f"torch._int_mm {name}", lambda a=a, b=b: torch._int_mm(a, b))
             for name, (a, b) in layouts.items()]
    calls.append(("torch.mm bf16 [f r]^T [f r], fp32 out",
                  lambda: torch.mm(XbT, Xb, out_dtype=torch.float32)))
    want = [torch.zeros((N, N), dtype=torch.int64, device=f.device)
            for _ in range(2)]
    ck.pair_counts_plain(f, r, *want)
    for label, call in calls:
        G = call().to(torch.int64)
        max_abs_err(f"library {label}",
                    [G[:N, N:2 * N],
                     torch.triu(G[:N, :N] + G[N:2 * N, N:2 * N])], want)
    return calls


def _drain_inputs(seed: int, n_nodes: int, n_pairs: int, read_len: int):
    """Random nodes and read pairs drawn from them, both strands."""
    import numpy as np
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [bases[rng.randint(0, 4, n)].tobytes().decode()
            for n in rng.randint(read_len + 20, 600, n_nodes)]
    comp = str.maketrans("ACGT", "TGCA")

    def draw():
        ref = refs[rng.randint(n_nodes)]
        p = rng.randint(0, len(ref) - read_len)
        read = ref[p: p + read_len]
        return read if rng.rand() < 0.5 else read.translate(comp)[::-1]

    pairs = [(draw().encode(), draw().encode()) for _ in range(n_pairs)]
    fc, fl = _pack([f for f, _ in pairs], pad_to_multiple=32)
    rc, rl = _pack([r for _, r in pairs], pad_to_multiple=32)
    return ([str(i) for i in range(n_nodes)], refs,
            ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs))


def pinned_drain_check() -> dict:
    """Phase 5a: the dense engine's drain into page-locked host memory.
    On 400 random nodes and 20,000 pairs (k = 21, batch 4,096) the CUDA
    engine's node_mat and short_mat must be page-locked
    (`torch.from_numpy(a).is_pinned()`), C-contiguous, writable and equal
    to the CPU engine's; with the first result dropped, a second call's
    arrays must lie in the same two blocks (their `ctypes.data`), and each
    call's `pe.d2h_pinned_bytes` must equal its `pe.d2h_bytes` less the
    table build's 16-byte readback. Then, at
    zikv15's N = 3,056, the drain of two zero int64 [N, N] accumulators
    timed against the pageable `.cpu().numpy()` pair it replaced, each
    while holding its three latest results (as the benchmark's loop
    does)."""
    import numpy as np
    import torch
    from vstrains_tpu_torch.ops import pe_infer as TP
    from vstrains_tpu_torch.utils import tracing

    ids, refs, reads = _drain_inputs(11, 400, 20_000, 100)
    kw = dict(batch_size=4096, stats_mode="dense")
    ref = TP.infer_pe_links(ids, refs, reads, 21, device="cpu", **kw)

    def run():
        before = tracing.totals()
        res = TP.infer_pe_links(ids, refs, reads, 21, device="cuda", **kw)
        got = {k: v - before["counters"].get(k, 0)
               for k, v in tracing.totals()["counters"].items()}
        drain_s = (tracing.totals()["span_ns"]["pe.drain"]
                   - before["span_ns"].get("pe.drain", 0)) * 1e-9
        for name in ("node_mat", "short_mat"):
            a = getattr(res, name)
            if not torch.from_numpy(a).is_pinned():
                raise AssertionError(f"pinned drain: {name} is pageable")
            if not (a.dtype == np.int64 and a.flags.c_contiguous
                    and a.flags.writeable):
                raise AssertionError(f"pinned drain: {name} {a.dtype} "
                                     f"{a.flags}")
            np.testing.assert_array_equal(a, getattr(ref, name))
        # the engine's D2H: the drain, page-locked, and the table build's
        # two integers
        drained = 2 * len(ids) ** 2 * 8
        if not (got["pe.d2h_pinned_bytes"] == drained
                and got["pe.d2h_bytes"] == drained + 16):
            raise AssertionError(f"pinned drain: counters {got}")
        return res, drain_s

    res, first_s = run()
    blocks = {res.node_mat.ctypes.data, res.short_mat.ctypes.data}
    del res
    res, second_s = run()
    again = {res.node_mat.ctypes.data, res.short_mat.ctypes.data}
    if again != blocks:
        raise AssertionError(f"pinned drain: blocks not reused {blocks} -> "
                             f"{again}")
    links = int(ref.node_mat.sum()), int(ref.short_mat.sum())
    del res, ref

    N = 3056
    accs = [torch.zeros((N, N), dtype=torch.int64, device="cuda")
            for _ in range(2)]

    def pageable():
        return tuple(a.cpu().numpy() for a in accs)

    def timed(drain, reps=12):
        held, ms = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            held.append(drain())
            ms.append((time.perf_counter() - t0) * 1e3)
            held = held[-3:]
        return ms

    pinned_ms = timed(lambda: TP._drain_dense(*accs))
    pageable_ms = timed(pageable)
    out = {"links": links, "first_drain_ms": round(first_s * 1e3, 3),
           "second_drain_ms": round(second_s * 1e3, 3),
           "zikv_n": N, "pinned_ms": [round(x, 2) for x in pinned_ms],
           "pageable_ms": [round(x, 2) for x in pageable_ms],
           "pinned_median_ms": round(float(np.median(pinned_ms)), 3),
           "pageable_median_ms": round(float(np.median(pageable_ms)), 3)}
    say("phase 5a (dense drain, page-locked): arrays pinned and equal to "
        "the CPU engine's, blocks reused, pe.d2h_pinned_bytes = "
        f"pe.d2h_bytes - 16 (the table build's readback); "
        f"{json.dumps(out)}")
    return out


def _bench_graph(config: str, seed: int):
    """The node sequences that `portbench/gen` makes for a benchmark
    configuration at generator seed `seed`, in its GFA's order (longest
    first), and the table's split_len; no reads are drawn."""
    from portbench.gen import hivsim
    with open(os.path.join(REPO, "portbench", "configs",
                           f"{config}.json")) as fh:
        spec = json.load(fh)["dataset"]
    params = spec["params"]
    if spec["generator"] == "make_hiv_dataset":
        genomes, _ = hivsim.simulate_strains(params["genome_len"], seed=seed)
    else:
        genomes, _ = hivsim.simulate_random_phylogeny(
            params["n_strains"], params["genome_len"], seed=seed,
            branch_rate=params["branch_rate"])
    unitigs = hivsim._build_unitigs(genomes, params["km"])[0]
    return sorted(unitigs, key=lambda u: (-len(u), u)), params["km"]


def card_table_check() -> dict:
    """Phase 5c (`--card-table` runs it alone): the PE k-mer table built on
    the card (`pe_infer._card_table` and the payloads in
    `_device_table`) against the host build (the C++ path, then
    `_build_sortfill_payloads`) on the graphs of an hiv_labmix, a zikv15
    and an hcmv3 dataset from `portbench/gen`: every entry array with its
    padding, max_dup, the entry count, the payloads, the classic probe's
    record and bucket index, bit for bit. Then each route timed, the
    median of five after one warm-up: the card's (the host encode, then
    the build and payloads: CUDA events and the host wall, readback
    included) beside the host's (C++ build, host payloads, and their
    H2D with the table's upload)."""
    import numpy as np
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as TP

    dev = torch.device("cuda")
    out = {}
    for config, seed in (("hiv_labmix", 0), ("zikv15", 1), ("hcmv3", 1)):
        seqs, L = _bench_graph(config, seed)
        host = TP._build_kmer_table(seqs, L)
        table = TP.build_kmer_table(seqs, L)
        card = TP._card_table(table, dev)
        for f in ("h1_biased", "h2", "node", "offset"):
            if not np.array_equal(getattr(card, f).cpu().numpy(),
                                  getattr(host, f)):
                raise AssertionError(f"{config}: the card's {f} differs "
                                     "from the host build's")
        if (card.max_dup, card.num_entries) != (host.max_dup,
                                                 host.num_entries):
            raise AssertionError(f"{config}: card (max_dup, entries) "
                                 f"{(card.max_dup, card.num_entries)} != "
                                 f"{(host.max_dup, host.num_entries)}")
        nb = TP._sortfill_node_bits(len(seqs))
        tab = TP._device_table(card, "sortfill")
        want = TP._build_sortfill_payloads(host, nb)
        if not np.array_equal(tab.pays.cpu().numpy(), want):
            raise AssertionError(f"{config}: the card's payloads differ")
        rec = ck.table_record(*(torch.from_numpy(getattr(host, f))
                                for f in ("h1_biased", "h2", "node")))
        if not torch.equal(TP._device_table(card, "join").rec.cpu(), rec):
            raise AssertionError(f"{config}: the card's record differs")
        starts, shift, depth = TP._card_bucket_index(card)
        w_starts, w_shift, w_depth = TP._bucket_index(host)
        if not (np.array_equal(starts.cpu().numpy(), w_starts)
                and (shift, depth) == (w_shift, w_depth)):
            raise AssertionError(f"{config}: the card's bucket index "
                                 "differs")

        times = {"card_ms": [], "card_wall_ms": [], "encode_ms": [],
                 "host_wall_ms": [], "host_build_ms": []}
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = TP.build_kmer_table(seqs, L)
            t1 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            TP._device_table(TP._card_table(t, dev), "sortfill")
            end.record()
            end.synchronize()
            t2 = time.perf_counter()
            h0 = time.perf_counter()
            ht = TP._build_kmer_table(seqs, L)
            h1 = time.perf_counter()
            TP._upload(ht.h1_biased, dev)
            TP._upload(TP._build_sortfill_payloads(ht, nb), dev)
            torch.cuda.synchronize()
            h2 = time.perf_counter()
            if i:
                times["encode_ms"].append((t1 - t0) * 1e3)
                times["card_ms"].append(start.elapsed_time(end))
                times["card_wall_ms"].append((t2 - t0) * 1e3)
                times["host_build_ms"].append((h1 - h0) * 1e3)
                times["host_wall_ms"].append((h2 - h0) * 1e3)
        med = {k: float(np.median(v)) for k, v in times.items()}
        out[config] = dict(nodes=len(seqs), entries=host.num_entries,
                           padded=int(host.h1_biased.size),
                           max_dup=host.max_dup,
                           codes_bytes=int(table.codes.nbytes), **med)
        say(f"card table ({config}, generator seed {seed}): N = "
            f"{len(seqs)}, {host.num_entries} entries (padded "
            f"{host.h1_biased.size}), max_dup {host.max_dup}: bit-equal to "
            f"the host build with payloads, record and bucket index; card "
            f"route {med['card_wall_ms']:.3f} ms wall (encode "
            f"{med['encode_ms']:.3f}, CUDA events {med['card_ms']:.3f}) "
            f"against the host route {med['host_wall_ms']:.3f} ms (C++ "
            f"build {med['host_build_ms']:.3f})")
    return out


def _coo_skewed_lists(rng, B: int, cap: int, N: int):
    """Synthetic (2B, cap) saturated lists at the sparse engine's shape:
    each read end a run of consecutive node ids from a position along a
    graph of N nodes, its mate's near it; positions from a Zipf law, so a
    few regions hold most pairs and keys repeat; run lengths geometric
    (mean ~3), 1 in 64 full at cap."""
    import numpy as np
    pos = (rng.zipf(1.3, B) * 7919) % N
    base = np.concatenate([pos, pos + rng.randint(1, 40, B)])
    base = np.minimum(base, N - cap)
    n = np.minimum(rng.geometric(0.3, 2 * B), cap)
    n[rng.rand(2 * B) < 1 / 64] = cap
    col = np.arange(cap)[None, :]
    return np.where(col < n[:, None], base[:, None] + col,
                    -1).astype(np.int32)


def l2_atomic_rate() -> float:
    """int64 atomic adds a second into an L2-resident table, the
    yardstick of coo_accum's bound: torch's index_add_ (one atomicAdd an
    element) of 2^22 ones at random slots of a 2^20-slot int64 table (8
    MB), CUDA events."""
    import torch
    tab = torch.zeros(2**20, dtype=torch.int64, device="cuda")
    idx = torch.randint(0, 2**20, (2**22,), device="cuda")
    ones = torch.ones(2**22, dtype=torch.int64, device="cuda")
    for _ in range(3):
        tab.index_add_(0, idx, ones)
    return 2**22 / (cuda_ms(lambda: tab.index_add_(0, idx, ones), 20)
                    * 1e-3)


NO_LIBRARY_COO = ("none: no PyTorch call counts keys into a table that "
                  "lives across calls (torch.unique sorts each batch)")


def coo_accum_check() -> dict:
    """Phase 6a (`--coo-accum` runs it alone): the sparse engine's link
    keys counted on the card. coo_accum and the driver's finish
    (pe_infer._coo_finish) against the plain version (the host COO), equal
    entry for entry with equal counters: on the (2B, cap) lists of a cut
    hcmv3 run (the configuration's genome and graph at 100x, generator
    seed 1, batch 16,384, its lists from the CUDA engine's own tail), also
    across a rehash of both tables, and on synthetic lists at 2B = 32,768 x
    cap 16 with skewed keys. Then the engine on that dataset on the card
    against the benchmark's plain reference (exact k-mers), once at the
    tables' first size (no growth) and once from 4,096 slots (growth
    forced: restarts and rehashes, `pe.coo_table_grows`), both with
    coo_accum launched. Each batch shape timed: the kernel into tables
    that hold the pass's keys and into empty ones (CUDA events), beside
    its bound (the batch's distinct keys, one atomic add each, at the
    card's measured L2 atomic rate) and the plain version's host
    time."""
    import logging

    import numpy as np
    import torch

    from portbench import data as pdata
    from portbench.gen import hivsim
    from portbench.loops import pe_engine_coo
    from portbench.reference import pe_links
    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as TP
    from vstrains_tpu_torch.utils import tracing

    dev = torch.device("cuda")
    no = {d: torch.zeros((), dtype=torch.bool, device=d)
          for d in ("cuda", "cpu")}

    def accumulate(lists, N, d, grow_at_end=False):
        tables = ck.CooTables(N, d)
        for out in lists:
            ck.coo_accum(torch.from_numpy(out).to(d), no[d], tables)
        if grow_at_end:
            tables.grow(0)
            tables.grow(1)
        stats = tables.stats.tolist()
        return TP._coo_finish(tables, stats[ck.COO_FILL:ck.COO_FILL + 2]), \
            stats

    def same(label, lists, N, grow_at_end=False):
        got, gs = accumulate(lists, N, "cuda", grow_at_end)
        want, ws = accumulate(lists, N, "cpu", grow_at_end)
        if gs != ws or not all(np.array_equal(g, w)
                               for g, w in zip(got, want)):
            raise AssertionError(f"coo_accum ({label}): differs from the "
                                 f"plain version: stats {gs} != {ws}")
        say(f"coo_accum ({label}): equal to plain, {len(lists)} batches, "
            f"{gs[ck.COO_KEYS]} keys, {gs[ck.COO_FILL]} + "
            f"{gs[ck.COO_FILL + 1]} distinct")
        return gs

    rate = l2_atomic_rate()
    say(f"L2 atomics: {rate / 1e9:.3f} G int64 atomic adds/s (index_add_ "
        "into an 8 MB table)")

    def timed(label, out, N):
        d_out = torch.from_numpy(out).to(dev)
        warm = ck.CooTables(N, dev)
        ck.coo_accum(d_out, no["cuda"], warm)
        ms = cuda_ms(lambda: ck.coo_accum(d_out, no["cuda"], warm), 20)
        fresh = iter([ck.CooTables(N, dev) for _ in range(6)])
        ms_fresh = cuda_ms(lambda: ck.coo_accum(d_out, no["cuda"],
                                                next(fresh)), 6)
        plain_ms = []
        for _ in range(3):
            tables = ck.CooTables(N, "cpu")
            t0 = time.perf_counter()
            ck.coo_accum_plain(torch.from_numpy(out), no["cpu"], tables)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        stats = tables.stats.tolist()
        distinct = stats[ck.COO_FILL] + stats[ck.COO_FILL + 1]
        res = {"kernel": "coo_accum", "shape": label, "max_abs_err": 0.0,
               "ms": ms, "ms_empty_tables": ms_fresh,
               "plain_ms": float(np.median(plain_ms)),
               "library_ms": None, "library": NO_LIBRARY_COO,
               "keys": stats[ck.COO_KEYS], "distinct_keys": distinct,
               "bound_ms": distinct / rate * 1e3,
               "bound_by": "L2 atomics",
               "bound_rate": f"{rate / 1e9:.3f} G int64 atomic adds/s, "
                             "measured (index_add_)"}
        say(f"kernel coo_accum ({label}): {ms:.4f} ms into tables holding "
            f"its keys, {ms_fresh:.4f} ms into empty ones; plain (host) "
            f"{res['plain_ms']:.2f} ms; {stats[ck.COO_KEYS]} keys, "
            f"{distinct} distinct; bound {res['bound_ms']:.4f} ms (L2 "
            f"atomics), {100 * res['bound_ms'] / ms:.1f}% of it")
        return res

    # a cut hcmv3 run: its lists from the engine's own tail on the card
    with open(os.path.join(REPO, "portbench", "configs", "hcmv3.json")) as fh:
        params = dict(json.load(fh)["dataset"]["params"], coverage=100.0)
    t0 = time.time()
    ds = hivsim.make_benchmark_dataset(os.path.join(WORK, "hcmv3_cut"),
                                       seed=1, **params)
    ids, seqs, k = pdata.read_gfa(ds.gfa_path)
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, k + 1,
                            pad_to_multiple=32)
    N = len(ids)
    say(f"hcmv3 cut: N = {N}, {reads.num_pairs} pairs, generated and "
        f"loaded in {time.time() - t0:.1f} s")
    logger = logging.getLogger("chip_smoke.coo_accum")
    table = TP._card_table(TP.build_kmer_table(seqs, k + 1), dev)
    tab = TP._device_table(table, TP._route_probe("sort", True, table,
                                                  logger))
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    lists = []
    for kind, payload in TP._wire_batches(reads, 16384):
        feed = TP._upload_batch(kind, payload, dev)
        out, ovf, _ = TP._sparse_core(
            *TP._batch_hashes(kind, feed, T, tab.split_len), tab, 16, 32)
        if bool(ovf):
            raise AssertionError("hcmv3 cut: a batch overflowed cap 16")
        lists.append(out.cpu().numpy())
    label = f"hcmv3 cut, 2B={lists[0].shape[0]} cap=16 N={N}"
    same(label, lists, N)
    same(label + ", both tables rehashed 4x", lists, N, grow_at_end=True)
    rng = np.random.RandomState(17)
    syn = [_coo_skewed_lists(rng, 16384, 16, 8700) for _ in range(3)]
    same("synthetic skewed, 2B=32768 cap=16 N=8700", syn, 8700)
    checks = [timed(label, lists[0], N),
              timed("synthetic skewed, 2B=32768 cap=16 N=8700", syn[0],
                    8700)]

    ref = pe_links.pe_links(seqs, pe_links.load_reads(ds.fwd_path,
                                                      ds.rve_path, k + 1),
                            k, dev)
    engine = {}
    for name, slots in (("first size", None), ("from 4,096 slots", 4096)):
        ck.reset_launches()
        before = tracing.totals()["counters"]
        res = TP._infer_pe_links_sparse(ids, tab, reads, 16384,
                                        logger, coo_slots=slots)
        got = tracing.totals()["counters"]
        grows = got["pe.coo_table_grows"] - before.get("pe.coo_table_grows",
                                                       0)
        node, short, bad = pe_engine_coo.matrices(res, N, dev)
        differ = int((node != ref.node_mat).sum()
                     + (short != ref.short_mat).sum()) + bad
        launched = ck.LAUNCHES["coo_accum"]
        if differ or not launched or (grows > 0) != (slots is not None):
            raise AssertionError(f"hcmv3 cut engine ({name}): {differ} "
                                 f"link entries differ, coo_accum "
                                 f"launched {launched}, grows {grows}")
        engine[name] = {"coo_accum_launches": launched,
                        "coo_table_grows": grows,
                        "pair_keys": int(res.pair_keys.size),
                        "short_keys": int(res.short_keys.size)}
    say(f"hcmv3 cut engine on the card: equal to the plain reference, "
        f"{json.dumps(engine)}")
    shutil.rmtree(os.path.join(WORK, "hcmv3_cut"), ignore_errors=True)
    return {"checks": checks, "engine": engine,
            "l2_atomic_rate": rate}


def count_launches(name: str, run, expect_on, expect_off=()) -> dict:
    """Run one path with every launch count set to 0 just before and
    read just after; fail unless each kernel of the path launched and
    none of `expect_off` did, nor sort_cols (no path calls it)."""
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launches()
    out = run()
    launches = dict(ck.LAUNCHES)
    say(f"{name}: kernel launches {launches}")
    missing = [k for k in expect_on if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched on this "
                             f"path: {missing}")
    extra = [k for k in set(expect_off) | {"sort_cols"}
             if k not in expect_on and launches[k] != 0]
    if extra:
        raise AssertionError(f"{name}: kernels of another path launched: "
                             f"{extra}")
    return launches, out


_SPARSE_LINE = "sparse PE stats path: "


def sparse_run_shape(lines) -> dict:
    """{"N", "cap", "depth", "batch"} of the sparse engine's last pass,
    from its log line; raises when the sparse engine did not run."""
    shape = None
    for line in lines:
        if _SPARSE_LINE in line:
            shape = {k: int(v) for k, v in (
                kv.split("=") for kv in
                line.split(_SPARSE_LINE)[1].strip().split(", "))}
    if shape is None:
        raise AssertionError("the sparse PE stats path did not run")
    return shape


def sparse_path_kernels(what: str, reads, split_len: int, shape: dict,
                        rng, force_bytes: bool = False) -> dict:
    """The sparse path's kernels against their plain versions at the
    shapes that path gave them: window_hashes on the first batch the
    engine fed it (the same batching and feed, bit-equal; the classic
    probe's runs take the byte feed), sort_rows on rows of K * depth slots
    for each of the batch's 2B read ends, with (key, val) as the
    compaction sorts and key-only as the packed `_row_run_stats` sorts.
    Returns the comparisons."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    batch, depth = shape["batch"], shape["depth"]
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    K = T - split_len + 1
    kind, payload = next(P._wire_batches(reads, batch,
                                         force_bytes=force_bytes))
    out = []
    if kind == "wire":
        wire = torch.from_numpy(payload).cuda()
        label = f"{what}, wire feed, 2B={2 * batch} T={T}"
        out.append(dict(compare(
            f"window_hashes ({label} split_len={split_len})",
            lambda: ck.window_hashes_wire(wire, T, split_len),
            lambda: ck.window_hashes_plain(*ck.unpack_wire_plain(wire, T),
                                           split_len), iters=5,
            bound_=hash_bound(wire.numel(), 2 * batch, K),
            library=NO_LIBRARY_HASH), kernel="window_hashes", shape=label))
        del wire
    else:
        codes, lens = (torch.from_numpy(x).cuda()
                       for x in P._stack_ends_np(*payload))
        label = f"{what}, byte feed, 2B={2 * batch} T={T}"
        out.append(dict(compare(
            f"window_hashes ({label} split_len={split_len})",
            lambda: ck.window_hashes_bytes(codes, lens, split_len),
            lambda: ck.window_hashes_plain(codes, lens, split_len), iters=5,
            bound_=hash_bound(codes.numel() + 4 * lens.numel(), 2 * batch,
                              K),
            library=NO_LIBRARY_HASH), kernel="window_hashes", shape=label))
        del codes, lens
    key, val = sort_operands(rng, 2 * batch, K * depth)
    for v, form in ((val, "(key, val)"), (None, "key-only")):
        label = f"{what} sparse tail, {form}, R={2 * batch} C={K * depth}"
        out.append(dict(compare(
            f"sort_rows ({label})", lambda v=v: ck.sort_rows(key, v),
            lambda v=v: ck.sort_rows_plain(key, v),
            bound_=sort_bound(key, v), library=sort_library(key, v)),
            kernel="sort_rows", shape=label))
    return out


def hiv_sparse_phase(hiv: dict, hiv_data: str, rng) -> dict:
    """The HIV CLI at --pe-batch-size 262144: the port's own cutover
    (dense_budget_rows) sends the PE stage (N >= 238 nodes) to the sparse
    engine. Then the path's kernels at the shapes it gave them."""
    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.ops import pe_infer as P

    out = os.path.join(WORK, "hiv_sparse_out")
    pe_batch = 262144
    launches, wall = count_launches(
        "hiv sparse", lambda: run_cli(hiv, hiv_data, out, pe_batch=pe_batch),
        ("window_hashes", "sort_rows", "coo_accum"),
        ("stats_accum", "pair_counts", "dup_scan", "dup_stats"))
    with open(os.path.join(out, "vstrains.log")) as fh:
        shape = sparse_run_shape(fh)
    say(f"hiv sparse: sparse PE stats path ran: {json.dumps(shape)}")
    if shape["N"] < 238 or not pe_batch > P.dense_budget_rows(shape["N"]):
        raise AssertionError(f"hiv sparse: N={shape['N']} should be >= 238 "
                             f"and past the dense budget")
    check_digests("HIV output (sparse engine)", out, hiv["outputs"])
    with open(os.path.join(out, "timings.json")) as fh:
        stages = {s["stage"]: s["seconds"]
                  for s in json.load(fh)["stages"]}
    say(f"hiv sparse: port CLI {wall:.2f} s, PE stage "
        f"{stages['pe_inference']:.3f} s; outputs byte-equal to the JAX "
        "record")
    # the pipeline's own load of the reads, as the PE stage ran it
    _, split_len = read_gfa(os.path.join(
        hiv_data, "assembly_graph_after_simplification.gfa"))
    reads = load_read_pairs(os.path.join(hiv_data, "reads_1.fastq"),
                            os.path.join(hiv_data, "reads_2.fastq"),
                            split_len, pad_to_multiple=32)
    return launches, sparse_path_kernels("HIV", reads, split_len, shape, rng)


def _keep_log(name: str):
    """A logger whose messages land in the returned list."""
    import logging
    log = logging.getLogger(name)
    messages = []

    class _Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    log.addHandler(_Keep())
    log.setLevel(logging.INFO)
    return log, messages


def cell_50k(rec: dict, rng) -> dict:
    """The N = 50,000 cell through infer_pe_links(stats_mode="auto")."""
    import torch

    from bench import synth_workload
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu_torch.ops import pe_infer as P

    t0 = time.time()
    refs, fwd, rve, k = synth_workload(**rec["generator"]["kwargs"])
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    del fwd, rve
    ids = [str(i) for i in range(len(refs))]
    n_all = len(fl)
    say(f"50k cell: {len(refs)} nodes, {n_all} pairs generated in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    table = P.build_kmer_table(refs, k + 1)
    build_s = time.time() - t0
    card = P._card_table(table, torch.device("cuda"))
    N = table.num_nodes
    budget_rows = P.dense_budget_rows(N)
    batch = rec["batch_size"]
    if not batch > budget_rows:
        raise AssertionError(f"50k: dense budget {budget_rows} rows would "
                             f"keep batch {batch} dense")
    say(f"50k cell: table {card.num_entries} entries, max_dup "
        f"{card.max_dup}, encoded in {build_s:.3f} s; dense budget "
        f"{budget_rows} rows < batch {batch}: auto routes to sparse")

    log, messages = _keep_log("chip_smoke.r50k")

    def engine(n):
        reads = ReadPairBatch(fc[:n], fl[:n], rc[:n], rl[:n], 0, 0, n)
        torch.cuda.synchronize()
        t = time.time()
        res = P.infer_pe_links(ids, refs, reads, k, batch_size=batch,
                               stats_mode="auto", table=table, logger=log,
                               device="cuda")
        torch.cuda.synchronize()
        return res, time.time() - t

    # (a) the checked run, which is also the timed run's warm-up
    n_chk = rec["checked_pairs"]
    save_workload(R50K_INPUTS, refs, k, fc[:n_chk], fl[:n_chk], rc[:n_chk],
                  rl[:n_chk])
    launches, (res, sec) = count_launches(
        "50k checked run", lambda: engine(n_chk),
        ("window_hashes", "sort_rows"),
        ("stats_accum", "pair_counts", "dup_scan", "dup_stats"))
    if not isinstance(res, P.PESparseResult):
        raise AssertionError("50k: auto routing did not pick the sparse "
                             "engine")
    out = os.path.join(WORK, "r50k_out")
    os.makedirs(out, exist_ok=True)
    P.write_pe_files_sparse(res, os.path.join(out, "pe_info"),
                            os.path.join(out, "st_info"))
    check_digests("50k checked run", out, rec["outputs"])
    shape = sparse_run_shape(messages)
    say(f"50k checked run: {n_chk} pairs in {sec:.3f} s; pe_info/st_info "
        f"byte-equal to the JAX record; sparse path {json.dumps(shape)}")
    # the path's kernels at the shapes it gave them
    checks = sparse_path_kernels(
        "N=50k", ReadPairBatch(fc, fl, rc, rl, 0, 0, n_all), k + 1, shape,
        rng)
    # (b) the timed run on every pair
    torch.cuda.reset_peak_memory_stats()
    messages.clear()
    res, sec = engine(n_all)
    retries = [m for m in messages if "overflowed" in m]
    peak = torch.cuda.max_memory_allocated() / 2**20
    batch = sparse_run_shape(messages)["batch"]
    if not isinstance(res, P.PESparseResult) or not res.pair_counts.size:
        raise AssertionError("50k timed run: no sparse links")
    say(f"50k timed run: {n_all} pairs in {sec:.4f} s = {n_all / sec:.1f} "
        f"pairs/s; table encode {build_s:.4f} s; {-(-n_all // batch)} "
        f"batches of {batch}; peak device memory {peak:.0f} MiB; cap retries "
        f"{len(retries)}; {res.pair_keys.size} PE links, "
        f"{res.short_keys.size} same-end links")
    return checks


NO_LIBRARY_DUP = {
    "dup_stats": "none: no single PyTorch call computes the duplicate-run "
                 "walk and the two scatters (count and min)",
    "dup_scan": "none: no single PyTorch call computes the duplicate-run "
                "walk's gathers and compares"}
L2_BYTES = 50e6      # the H100's L2 cache
ENTRY_BYTES = 12     # a table entry's h1, h2 and node


def dup_walk_entries(q1, valid, lo, tab_h1, depth: int):
    """The table entries the classic kernels' walk examines for each
    window, int64 [R, K]: from loc = min(lo, M - 1) through the first
    entry whose h1 exceeds q1 (the equal-h1 run and one entry past it,
    when lo is the join's bound), at most min(depth, M - loc); 0 for an
    invalid window."""
    import torch
    M = tab_h1.shape[0]
    loc = lo.to(torch.int64).clamp(max=M - 1)
    hi = torch.searchsorted(tab_h1, q1.reshape(-1), side="right").reshape(
        q1.shape)
    n = torch.minimum((hi - loc).clamp(min=0) + 1, (M - loc).clamp(max=depth))
    return torch.where(valid, n, 0)


def dup_table_bytes(lo, n, M: int, l2_bytes: float = L2_BYTES) -> tuple:
    """(distinct entries, bytes, how counted) of the table the walks need,
    each entry read once however many windows walk it: the union of the
    entries [loc, loc + n) over the windows (n from dup_walk_entries), 12
    bytes an entry where the table at 12 bytes an entry fits the L2, else
    for each maximal run of L adjacent entries in the union the ceil(12 L
    / 32) sectors of 32 bytes that hold it at best."""
    import torch
    loc = lo.to(torch.int64).clamp(max=M - 1).reshape(-1)
    n = n.reshape(-1)
    loc, n = loc[n > 0], n[n > 0]
    edge = torch.zeros(M + 1, dtype=torch.int32, device=loc.device)
    ones = torch.ones_like(loc, dtype=torch.int32)
    edge.index_add_(0, loc, ones)
    edge.index_add_(0, loc + n, -ones)
    idx = torch.nonzero(torch.cumsum(edge[:M], 0, dtype=torch.int32) > 0)
    idx = idx.reshape(-1)
    if M * ENTRY_BYTES <= l2_bytes:
        return idx.numel(), ENTRY_BYTES * idx.numel(), "bytes (in L2)"
    # the runs of adjacent entries: their first positions in idx, and the end
    first = torch.nonzero(torch.diff(idx, prepend=idx[:1] - 2) != 1)
    cuts = torch.cat([first.reshape(-1), idx.new_tensor([idx.numel()])])
    runs = torch.diff(cuts)
    sectors = int(((ENTRY_BYTES * runs + 31) // 32).sum())
    return idx.numel(), 32 * sectors, "32-byte sectors (past L2)"


def dup_bound(win, tab_h1, depth: int, out_bytes: int) -> dict:
    """The classic kernels' bound: each window's q1, h2, lo (int32) and
    valid (uint8) read once, the outputs written once, and each table
    entry that some valid window's walk examines read once
    (dup_table_bytes)."""
    R, K = win[0].shape
    n = dup_walk_entries(win[0], win[2], win[3], tab_h1, depth)
    entries, table_bytes, how = dup_table_bytes(win[3], n, tab_h1.shape[0])
    res = bound(R * K * 13 + out_bytes + table_bytes)
    res.update(entries_walked=int(n.sum()), distinct_entries=entries,
               valid_windows=int(win[2].sum()), table_bytes=table_bytes,
               table_counted_as=how)
    return res


def classic_inputs(table, reads, batch: int, split_len: int):
    """The classic probe's operands on the card for the first `batch`
    pairs of `reads` (stacked, byte feed): the windows (q1, h2, valid, lo;
    lo from the join) and the device table as the path builds it."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P
    _, payload = next(P._wire_batches(reads, batch, force_bytes=True))
    codes, lens = (torch.from_numpy(x).cuda()
                   for x in P._stack_ends_np(*payload))
    q1, h2, valid = ck.window_hashes_bytes(codes, lens, split_len)
    tab = P._device_table(P._card_table(table, torch.device("cuda")), "join")
    return (q1, h2, valid, P._classic_lo(q1, tab)), tab


def dup_calls(kernel: str, win, table, depth: int, N: int):
    """(kernel call, plain call, output bytes) of dup_stats or dup_scan on
    the windows and the table record."""
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    R, K = win[0].shape
    if kernel == "dup_stats":
        return (lambda: ck.dup_stats(*win, table, depth, N),
                lambda: ck.dup_stats_plain(*win, table, depth, N),
                R * N * 8)
    return (lambda: ck.dup_scan(*win, table, depth),
            lambda: ck.dup_scan_plain(*win, table, depth), R * K * depth * 8)


def dup_compare(kernel: str, label: str, win, tab, depth: int,
                iters: int = 20) -> dict:
    """dup_stats or dup_scan against its plain version on the same
    operands and the table record the path passes, timed beside the
    bound."""
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    R, K = win[0].shape
    N = tab.num_nodes
    shape = f"{label}, R={R} K={K} D={depth}" + (
        f" N={N}" if kernel == "dup_stats" else "")
    kern, plain, out_bytes = dup_calls(kernel, win, tab.rec, depth, N)
    b = dup_bound(win, tab.h1, depth, out_bytes)
    res = compare(f"{kernel} ({shape})", kern, plain, iters=iters,
                  bound_=b, library=NO_LIBRARY_DUP[kernel])
    hits = (int(plain()[0].sum()) if kernel == "dup_stats" else
            int((plain()[0] != ck.INF).sum()))
    say(f"{kernel} ({shape}): {b['entries_walked']} table entries walked "
        f"by {b['valid_windows']} valid windows "
        f"({b['entries_walked'] / max(b['valid_windows'], 1):.4f} each), "
        f"{b['distinct_entries']} distinct of {tab.h1.shape[0]}: "
        f"{b['table_bytes']} table bytes in the bound, counted as "
        f"{b['table_counted_as']}; {hits} of {R * K * depth} slots "
        "matched")
    return dict(res, kernel=kernel, shape=shape)


# (R, K, D, real entries, M, N) of the classic kernels' ragged checks:
# rows not a whole number of a block's, D up to 64 and past dup_scan's
# 128-window staging (D = 300), K = 1 and K past a dup_stats block's 1,024
# threads, an unpadded table, and N past its shared counters (N = 30,000:
# global atomics)
CLASSIC_RAGGED = ((1001, 37, 3, 1000, 1024, 50), (5, 201, 64, 1000, 1024, 773),
                  (1, 1, 1, 1, 1024, 50), (257, 95, 40, 2048, 2048, 1024),
                  (3, 9, 17, 600, 1024, 50), (3, 1100, 2, 900, 1024, 50),
                  (2, 4, 300, 700, 1024, 50),
                  (4099, 95, 32, 5000, 8192, 6000),
                  (64, 95, 4, 1000, 1024, 30000))


def classic_ragged_case(rng, R: int, K: int, m_real: int, M: int, N: int):
    """A synthetic padded table with duplicate runs of any length (sorted
    h1; padding h1 = INT32_MAX, h2 = -1, node 0) and windows drawn from
    it: 20% misses, 10% scans from M (a lookup miss), the last row's from
    M - 3, queries equal to the padding, an all-invalid first row. Returns
    numpy (q1, h2, valid, lo) [R, K] and (h1, h2, node) [M]."""
    import numpy as np
    h1 = np.sort(rng.randint(-2**31, 2**31 - 1, m_real))
    for i in range(1, m_real):  # duplicate runs of any length
        if rng.rand() < 0.7:
            h1[i] = h1[i - 1]
    h1 = np.concatenate([h1, np.full(M - m_real, 2**31 - 1)])
    h2 = np.concatenate([rng.randint(-1, 3, m_real), np.full(M - m_real, -1)])
    node = np.concatenate([rng.randint(0, N, m_real),
                           np.zeros(M - m_real, np.int64)])
    q1 = h1[rng.randint(0, M, (R, K))]
    miss = rng.rand(R, K) < 0.2
    q1[miss] = rng.randint(-2**31, 2**31 - 1, int(miss.sum()))
    hq = rng.randint(-1, 3, (R, K))
    valid = rng.rand(R, K) < 0.9
    if R > 1:
        valid[0] = False
    lo = np.searchsorted(h1, q1, side="left")
    lo[rng.rand(R, K) < 0.1] = M
    if R > 2:
        lo[-1] = M - 3
    i32 = [np.ascontiguousarray(a, dtype=np.int32)
           for a in (q1, hq, lo, h1, h2, node)]
    return (i32[0], i32[1], valid, i32[2]), tuple(i32[3:])


def dup_ragged(rng) -> int:
    """dup_stats and dup_scan against their plain versions, untimed, at
    CLASSIC_RAGGED."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    n = 0
    for R, K, D, m_real, M, N in CLASSIC_RAGGED:
        win, tab = classic_ragged_case(rng, R, K, m_real, M, N)
        win = tuple(torch.from_numpy(a).cuda() for a in win)
        rec = ck.table_record(*(torch.from_numpy(a).cuda() for a in tab))
        for kernel in ("dup_stats", "dup_scan"):
            kern, plain, _ = dup_calls(kernel, win, rec, D, N)
            max_abs_err(f"{kernel} R={R} K={K} D={D} M={M} N={N}", kern(),
                        plain())
            n += 1
    return n


# rounds of the three classic modes on the HIV graph, each timed, so that
# a mode's engine wall is read beside its own spread
CLASSIC_ROUNDS = 3


def hiv_classic_phase(hiv: dict, hiv_data: str, hiv_out: str) -> tuple:
    """The dense HIV CLI run's graph (gfa/s_graph_L1.gfa, loaded as the
    pipeline's resume does) and reads (the pipeline's loader) through
    infer_pe_links in each classic probe mode on the card: "sortjoin",
    "lookup" (its bucket index built inside the call) and "searchsorted"
    (the CLI run was "sort"), CLASSIC_ROUNDS rounds of the three, each
    call timed. The first round's write_pe_files output must equal the
    HIV record's aln/pe_info and aln/st_info; each run must launch
    dup_stats, window_hashes and pair_counts, and not stats_accum,
    dup_scan or sort_rows. Then the device table's build alone, timed,
    and dup_stats at the HIV shapes. Returns (view, the dup_stats
    checks)."""
    import torch

    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.core.gfa import load_flipped_gfa
    from vstrains_tpu_torch.ops import pe_infer as P

    view = load_flipped_gfa(os.path.join(hiv_out, "gfa", "s_graph_L1.gfa"))
    ids = list(view.nodes.keys())
    seqs = [view.nodes[i].seq for i in ids]
    ksize = next(iter(view.edges.values())).overlap
    reads = load_read_pairs(os.path.join(hiv_data, "reads_1.fastq"),
                            os.path.join(hiv_data, "reads_2.fastq"),
                            ksize + 1, pad_to_multiple=32)
    t0 = time.time()
    table = P.build_kmer_table(seqs, ksize + 1)
    card = P._card_table(table, torch.device("cuda"))
    say(f"hiv classic: {len(ids)} nodes, {reads.num_pairs} pairs; table "
        f"{card.num_entries} entries, max_dup {card.max_dup}, built in "
        f"{time.time() - t0:.4f} s")
    want = {"pe_info": hiv["outputs"]["aln/pe_info"],
        "st_info": hiv["outputs"]["aln/st_info"]}
    dense = ("window_hashes", "dup_stats", "pair_counts")
    modes = ("sortjoin", "lookup", "searchsorted")
    walls = {mode: [] for mode in modes}
    peaks = {}
    for rnd in range(CLASSIC_ROUNDS):
        for mode in modes:
            def run(mode=mode):
                torch.cuda.synchronize()
                t = time.time()
                res = P.infer_pe_links(ids, seqs, reads, ksize,
                                       batch_size=16384, probe_mode=mode,
                                       table=table, device="cuda")
                torch.cuda.synchronize()
                return res, time.time() - t
            torch.cuda.reset_peak_memory_stats()
            _, (res, sec) = count_launches(
                f"hiv probe_mode={mode}", run, dense,
                ("stats_accum", "dup_scan", "sort_rows"))
            walls[mode].append(sec)
            if rnd:
                continue
            peaks[mode] = torch.cuda.max_memory_allocated() / 2**20
            out = os.path.join(WORK, f"hiv_{mode}")
            os.makedirs(out, exist_ok=True)
            P.write_pe_files(res, os.path.join(out, "pe_info"),
                             os.path.join(out, "st_info"))
            check_digests(f"HIV probe_mode={mode}", out, want)
    for mode in modes:
        say(f"hiv probe_mode={mode}: engine (table prebuilt) "
            f"{', '.join(f'{x:.4f}' for x in walls[mode])} s in "
            f"{CLASSIC_ROUNDS} rounds of the three modes, min "
            f"{reads.num_pairs / min(walls[mode]):.1f} pairs/s; peak device "
            f"memory {peaks[mode]:.0f} MiB; pe_info/st_info byte-equal to "
            "the JAX record (first round)")
    # what each classic call spends building the table and its record on
    # the card (an encoded table: _card_table), apart from the engine's
    # batches
    dev = torch.device("cuda")
    up = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.time()
        P._device_table(P._card_table(table, dev), "join")
        torch.cuda.synchronize()
        up.append(time.time() - t)
    say(f"hiv classic device table (built on the card: h1 and the [M, 4] "
        f"record, "
        f"{card.h1_biased.numel()} entries): "
        f"{', '.join(f'{x:.4f}' for x in up)} s")
    win, tab = classic_inputs(table, reads, 16384, ksize + 1)
    checks = [dup_compare("dup_stats", f"HIV D={d}", win, tab, d)
              for d in sorted({1, card.max_dup, 32})]
    del win, tab
    torch.cuda.empty_cache()
    return view, checks


def graph_phase(view) -> None:
    """The graph passes on the card: graph_is_dag_device on the HIV graph
    against the host DFS (algos.dag.graph_is_DAG), before and after one
    back edge; edge_flow_device on a seeded graph of 20,000 edges (the
    device path's own threshold) against the exact float64 host path."""
    import numpy as np

    from vstrains_tpu_torch.algos.dag import graph_is_DAG
    from vstrains_tpu_torch.core.graph import new_view
    from vstrains_tpu_torch.ops import graph_ops as G

    states = []
    for step in ("as loaded", "plus one back edge"):
        if states:  # the back edge closes a cycle u -> v -> u
            u, v = next((u, v) for u, v in view.edges
                        if u != v and (v, u) not in view.edges)
            view.add_edge(view.nodes[v], view.nodes[u],
                          view.edges[u, v].overlap)
        dev, host = (G.graph_is_dag_device(view.tensors(), device="cuda"),
                     graph_is_DAG(view))
        if dev != host:
            raise AssertionError(f"DAG check on the card {dev} != host "
                                 f"{host} ({step})")
        states.append(f"{step}: {dev}")
    if dev:
        raise AssertionError("a graph with a back edge passed as a DAG")
    say(f"graph_is_dag_device on the HIV graph ({view.tensors().num_nodes} "
        f"nodes) equals the host DFS: {'; '.join(states)}")
    rng = np.random.RandomState(7)
    g = new_view()
    n, m = 6000, 20_000
    nodes = [g.add_vertex(str(i), float(rng.randint(1, 500)), "ACGT" * 3)
             for i in range(n)]
    while g.num_edges() < m:
        a, b = (int(x) for x in rng.randint(0, n, 2))
        if a != b and (str(a), str(b)) not in g.edges:
            g.add_edge(nodes[a], nodes[b], 3)
    got = G.edge_flow_device(g.tensors(), device="cuda")
    G.assign_edge_flow(g, exact=True)
    want = np.array([e.flow for e in g.edges.values()])
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    rtol = 1e-6  # float32: exact integer sums, a few roundings of 2^-24
    if not (rel <= rtol).all():
        raise AssertionError(f"edge flow on the card: max relative error "
                             f"{rel.max():.3e} > rtol {rtol}")
    say(f"edge_flow_device on the card, {m} edges: max relative error "
        f"{rel.max():.3e} against the float64 host path (rtol {rtol})")


def repeat_cell(rec: dict) -> tuple:
    """The repeat cell (tools/repeat_workload: 1,024 nodes in 32 groups
    sharing an 80-bp motif, max_dup 32 > 16) through infer_pe_links on the
    card, dense (stats_mode="auto") and sparse: the classic join, both
    runs' write_pe_files output equal to the JAX record; then dup_stats at
    the dense run's shape, stats_accum at the slot plane it replaces there,
    and dup_scan at the sparse run's shape. Returns (the dense run's
    launches, the sparse run's, the dup_stats and dup_scan checks, the
    stats_accum check)."""
    import torch

    from tools.repeat_workload import repeat_workload, workload_digests
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    t0 = time.time()
    refs, fwd, rve, k = repeat_workload(**rec["generator"]["kwargs"])
    if workload_digests(refs, fwd, rve) != rec["inputs"]:
        raise AssertionError("repeat: generated inputs differ from the "
                             "JAX record's")
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fl))
    save_workload(REPEAT_INPUTS, refs, k, fc, fl, rc, rl)
    gen_s = time.time() - t0
    t0 = time.time()
    table = P.build_kmer_table(refs, k + 1)
    card = P._card_table(table, torch.device("cuda"))
    N, batch = table.num_nodes, rec["batch_size"]
    say(f"repeat cell: {N} nodes, {reads.num_pairs} pairs, generated in "
        f"{gen_s:.1f} s; table {card.num_entries} entries, max_dup "
        f"{card.max_dup} (> {P._SORTFILL_MAX_DUP}: the classic join), built "
        f"in {time.time() - t0:.4f} s; dense budget "
        f"{P.dense_budget_rows(N)} rows >= batch {batch}")
    if card.max_dup <= P._SORTFILL_MAX_DUP or batch > P.dense_budget_rows(N):
        raise AssertionError("repeat: the cell should be dense and past the "
                             "packed probe's 16 ranks")
    ids = [str(i) for i in range(N)]
    log, messages = _keep_log("chip_smoke.repeat")
    launches = {}
    for engine, stats_mode, on, off, kind in (
            ("dense", "auto", ("window_hashes", "dup_stats", "pair_counts"),
             ("sort_rows", "stats_accum", "dup_scan"), P.PEResult),
            ("sparse", "sparse", ("window_hashes", "dup_scan", "sort_rows"),
             ("stats_accum", "pair_counts", "dup_stats"),
             P.PESparseResult)):
        def run(stats_mode=stats_mode):
            torch.cuda.synchronize()
            t = time.time()
            res = P.infer_pe_links(ids, refs, reads, k, batch_size=batch,
                                   stats_mode=stats_mode, table=table,
                                   logger=log, device="cuda")
            torch.cuda.synchronize()
            return res, time.time() - t
        messages.clear()
        torch.cuda.reset_peak_memory_stats()
        got, (res, sec) = count_launches(f"repeat {engine}", run, on, off)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not isinstance(res, kind):
            raise AssertionError(f"repeat: the {engine} engine did not run")
        out = os.path.join(WORK, f"repeat_{engine}")
        os.makedirs(out, exist_ok=True)
        P.write_pe_files(res, os.path.join(out, "pe_info"),
                         os.path.join(out, "st_info"))
        check_digests(f"repeat {engine}", out, rec["outputs"])
        retries = [m for m in messages if "overflowed" in m]
        extra = ""
        if engine == "sparse":
            shape = sparse_run_shape(messages)
            extra = (f"; sparse path {json.dumps(shape)}, cap retries "
                     f"{len(retries)} {retries}")
        say(f"repeat {engine}: {reads.num_pairs} pairs in {sec:.4f} s = "
            f"{reads.num_pairs / sec:.1f} pairs/s; peak device memory "
            f"{peak:.0f} MiB; files byte-equal to the JAX record{extra}")
        launches[engine] = got
    D = card.max_dup
    win, tab = classic_inputs(table, reads, batch, k + 1)
    stats = dup_compare("dup_stats", "repeat cell dense", win, tab, D)
    # the slot plane dup_stats replaces, through the kernel that read it
    node_key, _ = ck.dup_scan_plain(*win, tab.rec, D)
    node_t = torch.where(node_key == ck.INF, N, node_key)
    R, C = node_t.shape
    plane = dict(compare(
        f"stats_accum (repeat cell's slot plane, R={R} C={C} N={N})",
        lambda: ck.stats_accum(node_t, D, N),
        lambda: ck.stats_accum_plain(node_t, D, N),
        bound_=bound(4 * R * C + 8 * R * N), library=NO_LIBRARY_STATS),
        kernel="stats_accum", shape=f"repeat cell, R={R} C={C} N={N}")
    del win, tab, node_key, node_t
    win, tab = classic_inputs(table, reads, shape["batch"], k + 1)
    scan = dup_compare("dup_scan", "repeat cell sparse", win, tab, D)
    del win, tab
    torch.cuda.empty_cache()
    return launches["dense"], launches["sparse"], stats, scan, plane


def repeat64_cell(rec: dict, rng) -> tuple:
    """The repeat64 cell (tools/repeat_workload with 16 groups of 64
    nodes: 1,024 nodes of 400 bp, max_dup 64, the classic join) through
    infer_pe_links on the card, dense (stats_mode="auto": dup_stats at
    depth 64) and sparse, whose tail sorts rows of K x 64 = 6,080 slots
    padded to 8,192 in sort_rows' one-block network: each engine on the
    first 65,536 pairs against the JAX record "repeat64", then timed on
    all 262,144; then window_hashes, sort_rows, dup_scan and dup_stats at
    the runs' shapes. Returns (the dense checked run's launches, the
    sparse one's, the kernel checks)."""
    import torch

    from tools.repeat_workload import repeat_workload, workload_digests
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.ops import pe_infer as P

    t0 = time.time()
    refs, fwd, rve, k = repeat_workload(**rec["generator"]["kwargs"])
    if workload_digests(refs, fwd, rve) != rec["inputs"]:
        raise AssertionError("repeat64: generated inputs differ from the "
                             "JAX record's")
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    n_all, n_chk = len(fl), rec["checked_pairs"]
    gen_s = time.time() - t0
    table = P.build_kmer_table(refs, k + 1)
    card = P._card_table(table, torch.device("cuda"))
    N, batch = table.num_nodes, rec["batch_size"]
    say(f"repeat64 cell: {N} nodes, {n_all} pairs generated in {gen_s:.1f} "
        f"s; table {card.num_entries} entries, max_dup {card.max_dup}")
    if card.max_dup != rec["max_dup"] or batch > P.dense_budget_rows(N):
        raise AssertionError("repeat64: max_dup differs from the record's, "
                             "or the cell is past the dense budget")
    ids = [str(i) for i in range(N)]
    log, messages = _keep_log("chip_smoke.repeat64")

    def engine(n, stats_mode):
        reads = ReadPairBatch(fc[:n], fl[:n], rc[:n], rl[:n], 0, 0, n)
        torch.cuda.synchronize()
        t = time.time()
        res = P.infer_pe_links(ids, refs, reads, k, batch_size=batch,
                               stats_mode=stats_mode, table=table,
                               logger=log, device="cuda")
        torch.cuda.synchronize()
        return res, time.time() - t

    launches = {}
    for name, stats_mode, on, off, kind in (
            ("dense", "auto", ("window_hashes", "dup_stats", "pair_counts"),
             ("sort_rows", "stats_accum", "dup_scan"), P.PEResult),
            ("sparse", "sparse", ("window_hashes", "dup_scan", "sort_rows"),
             ("stats_accum", "pair_counts", "dup_stats"),
             P.PESparseResult)):
        messages.clear()
        got, (res, sec) = count_launches(
            f"repeat64 {name} checked run",
            lambda stats_mode=stats_mode: engine(n_chk, stats_mode), on, off)
        widths = dict(ck.SORT_ROWS_WIDTHS)
        if not isinstance(res, kind):
            raise AssertionError(f"repeat64: the {name} engine did not run")
        out = os.path.join(WORK, f"repeat64_{name}")
        os.makedirs(out, exist_ok=True)
        P.write_pe_files(res, os.path.join(out, "pe_info"),
                         os.path.join(out, "st_info"))
        check_digests(f"repeat64 {name}", out, rec["outputs"])
        extra = ""
        if name == "sparse":
            shape = sparse_run_shape(messages)
            if widths.get(8192, 0) <= 0 or max(widths) > ck.SORT_NET_MAX:
                raise AssertionError(f"repeat64 sparse: sort_rows launches "
                                     f"by padded width {widths}: expected "
                                     "8,192 and none past the network")
            extra = (f"; sparse path {json.dumps(shape)}, sort_rows "
                     f"launches by padded width {widths}")
        say(f"repeat64 {name} checked run: {n_chk} pairs in {sec:.4f} s; "
            f"files byte-equal to the JAX record{extra}")
        launches[name] = got
        torch.cuda.reset_peak_memory_stats()
        messages.clear()
        res, sec = engine(n_all, stats_mode)
        retries = [m for m in messages if "overflowed" in m]
        say(f"repeat64 {name} timed run: {n_all} pairs in {sec:.4f} s = "
            f"{n_all / sec:.1f} pairs/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; cap "
            f"retries {len(retries)}")
    reads_all = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_all)
    checks = sparse_path_kernels("repeat64", reads_all, k + 1, shape, rng,
                                 force_bytes=True)
    D = card.max_dup
    for kernel, b, label in (("dup_stats", batch, "repeat64 dense"),
                             ("dup_scan", shape["batch"],
                              "repeat64 sparse")):
        win, tab = classic_inputs(table, reads_all, b, k + 1)
        checks.append(dup_compare(kernel, label, win, tab, D, iters=10))
        del win, tab
    torch.cuda.empty_cache()
    return launches["dense"], launches["sparse"], checks


def cell_300k(rec: dict, rng) -> list:
    """The N = 300,000 cell (`bench.synth_workload`, past the packed
    probe's 2^18 node ids): infer_pe_links(stats_mode="auto") routes it to
    the sparse engine and the classic join. A checked run on the first
    65,536 pairs against the JAX record, the path's kernels against their
    plain versions at that run's shapes, then the timed run on every
    pair."""
    import torch

    from bench import synth_workload
    from tools.repeat_workload import workload_digests
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu_torch.ops import pe_infer as P

    t0 = time.time()
    refs, fwd, rve, k = synth_workload(**rec["generator"]["kwargs"])
    gen_s = time.time() - t0
    t0 = time.time()
    if workload_digests(refs, fwd, rve) != rec["inputs"]:
        raise AssertionError("300k: generated inputs differ from the JAX "
                             "record's")
    digest_s = time.time() - t0
    t0 = time.time()
    fc, fl = _pack([x.encode() for x in fwd])
    rc, rl = _pack([x.encode() for x in rve])
    del fwd, rve
    pack_s = time.time() - t0
    ids = [str(i) for i in range(len(refs))]
    n_all = len(fl)
    t0 = time.time()
    table = P.build_kmer_table(refs, k + 1)
    build_s = time.time() - t0
    card = P._card_table(table, torch.device("cuda"))
    N = table.num_nodes
    batch = rec["batch_size"]
    if P._sortfill_node_bits(N) is not None or not \
            batch > P.dense_budget_rows(N):
        raise AssertionError("300k: should be past the packing and the "
                             "dense budget")
    say(f"300k cell: {N} nodes, {n_all} pairs; host seconds: generate "
        f"{gen_s:.2f}, input digests {digest_s:.2f}, pack {pack_s:.2f}, "
        f"table encode {build_s:.2f} ({card.num_entries} entries padded to "
        f"{card.h1_biased.numel()}, max_dup {card.max_dup})")
    log, messages = _keep_log("chip_smoke.r300k")

    def engine(n):
        reads = ReadPairBatch(fc[:n], fl[:n], rc[:n], rl[:n], 0, 0, n)
        torch.cuda.synchronize()
        t = time.time()
        res = P.infer_pe_links(ids, refs, reads, k, batch_size=batch,
                               stats_mode="auto", table=table, logger=log,
                               device="cuda")
        torch.cuda.synchronize()
        return res, time.time() - t

    n_chk = rec["checked_pairs"]
    launches, (res, sec) = count_launches(
        "300k checked run", lambda: engine(n_chk),
        ("window_hashes", "dup_scan", "sort_rows"),
        ("stats_accum", "pair_counts", "dup_stats"))
    if not isinstance(res, P.PESparseResult):
        raise AssertionError("300k: auto routing did not pick the sparse "
                             "engine")
    out = os.path.join(WORK, "r300k_out")
    os.makedirs(out, exist_ok=True)
    P.write_pe_files_sparse(res, os.path.join(out, "pe_info"),
                            os.path.join(out, "st_info"))
    check_digests("300k checked run", out, rec["outputs"])
    shape = sparse_run_shape(messages)
    say(f"300k checked run: {n_chk} pairs in {sec:.3f} s; pe_info/st_info "
        f"byte-equal to the JAX record ({rec['probe_mode']} probe there, "
        f"the join here); sparse path {json.dumps(shape)}")
    reads_all = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_all)
    checks = sparse_path_kernels("N=300k", reads_all, k + 1, shape, rng,
                                 force_bytes=True)
    win, tab = classic_inputs(table, reads_all, shape["batch"], k + 1)
    checks.append(dup_compare("dup_scan", "N=300k sparse", win, tab,
                              shape["depth"], iters=10))
    del win, tab
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    messages.clear()
    res, sec = engine(n_all)
    retries = [m for m in messages if "overflowed" in m]
    peak = torch.cuda.max_memory_allocated() / 2**20
    batch = sparse_run_shape(messages)["batch"]
    if not res.pair_counts.size:
        raise AssertionError("300k timed run: no sparse links")
    say(f"300k timed run: {n_all} pairs in {sec:.4f} s = {n_all / sec:.1f} "
        f"pairs/s; table encode {build_s:.4f} s; {-(-n_all // batch)} "
        f"batches of {batch}; peak device memory {peak:.0f} MiB; cap retries "
        f"{len(retries)}; {res.pair_keys.size} PE links, "
        f"{res.short_keys.size} same-end links; launches of the checked "
        f"run {json.dumps(launches)}")
    return checks


# --------------------------------------------------------------------------
# phases 10-14: per-component extraction and the parallel layer
# --------------------------------------------------------------------------

REPEAT_INPUTS = os.path.join(WORK, "repeat_inputs.npz")
R50K_INPUTS = os.path.join(WORK, "r50k_inputs.npz")
SP_SEQ_LEN = 100_000
SP_SPLIT_LEN = 56   # the HIV graph's k = 55, plus one
SP_TABLE_NODES = (2000, 16)  # nodes of 200-2,000 bp, and of 8-60 kb
DENSE = ("window_hashes", "stats_accum", "pair_counts")
ALL = ("window_hashes", "stats_accum", "pair_counts", "sort_rows",
       "dup_scan", "dup_stats", "sort_cols")


def save_workload(path: str, refs, k: int, fc, fl, rc, rl) -> None:
    """A generated cell's node sequences and packed read pairs, for the
    ranks of phase 12 to load instead of generating again."""
    import numpy as np
    np.savez(path, refs=np.array(refs), k=k, fc=fc, fl=fl, rc=rc, rl=rl)


def load_workload(path: str):
    import numpy as np

    from vstrains_tpu_torch.core.fastq import ReadPairBatch
    z = np.load(path)
    refs = [str(x) for x in z["refs"]]
    return ([str(i) for i in range(len(refs))], refs, int(z["k"]),
            ReadPairBatch(z["fc"], z["fl"], z["rc"], z["rl"], 0, 0,
                          int(z["fl"].shape[0])))


def hiv_inputs(hiv_out: str, hiv_data: str, stripe=None):
    """The dense HIV CLI run's simplified graph (ids, sequences, k) and
    its reads as the pipeline loads them, or one rank's stripe of them
    (parallel.distributed.host_read_stripe)."""
    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.core.gfa import load_flipped_gfa
    from vstrains_tpu_torch.parallel.distributed import host_read_stripe

    view = load_flipped_gfa(os.path.join(hiv_out, "gfa", "s_graph_L1.gfa"))
    ids = list(view.nodes.keys())
    seqs = [view.nodes[i].seq for i in ids]
    ksize = next(iter(view.edges.values())).overlap
    fq = [os.path.join(hiv_data, f"reads_{e}.fastq") for e in (1, 2)]
    if stripe is None:
        reads = load_read_pairs(*fq, ksize + 1, pad_to_multiple=32)
    else:
        reads = host_read_stripe(*fq, ksize + 1, *stripe)
    return ids, seqs, ksize, reads


def write_links(res, out: str, writer: str) -> None:
    from vstrains_tpu_torch.ops import pe_infer as P
    os.makedirs(out, exist_ok=True)
    getattr(P, writer)(res, os.path.join(out, "pe_info"),
                       os.path.join(out, "st_info"))


def metaviral_phase(rec: dict) -> str:
    """(10) BASELINE config 5 through the port CLI on cuda with
    --per-component and --component-workers 1 and 2: outputs byte-equal to
    the JAX record "metaviral", every planted haplotype recovered.
    Returns the dataset's directory."""
    from vstrains_tpu_torch.evals.nga50 import load_fasta

    data = os.path.join(WORK, "metaviral_data")
    ds = generate("synth", "make_multi_component_dataset", data,
                  rec["generator"]["kwargs"])
    check_digests("metaviral input", data, rec["inputs"])
    for w in (1, 2):
        out = os.path.join(WORK, f"metaviral_w{w}")
        _, wall = count_launches(
            f"metaviral --per-component --component-workers {w}",
            lambda out=out, w=w: run_cli(
                rec, data, out, extra=("--component-workers", str(w))),
            DENSE, ("sort_rows", "dup_scan", "dup_stats"))
        check_digests(f"metaviral ({w} worker(s))", out, rec["outputs"])
        strains = set(load_fasta(os.path.join(out, "strain.fasta"))
                      .values())
        hits = sum(h in strains for h in ds["haplotypes"])
        if hits != rec["strains"]:
            raise AssertionError(f"metaviral: {hits}/{rec['strains']} "
                                 "haplotypes recovered")
        with open(os.path.join(out, "timings.json")) as fh:
            stages = {x["stage"]: x["seconds"]
                      for x in json.load(fh)["stages"]}
        say(f"metaviral --per-component, {w} worker(s): port CLI "
            f"{wall:.2f} s (per_component_extraction "
            f"{stages['per_component_extraction']:.2f} s, pe_inference "
            f"{stages['pe_inference']:.3f} s); {hits}/{rec['strains']} "
            "haplotypes recovered; outputs byte-equal to the JAX record")
    return data


def nccl_world_phase(hiv: dict, hiv_data: str, hiv_out: str) -> None:
    """(11) infer_pe_links_sharded on the HIV graph and reads in a
    torch.distributed world of one rank over NCCL (a 1 x 1 mesh, the final
    reduce through NCCL), called twice (the first call's reduce sets up
    the NCCL communicator): write_pe_files byte-equal to the HIV record,
    the second call's links equal to the first's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vstrains_tpu_torch.parallel.distributed import init_distributed
    from vstrains_tpu_torch.parallel.mesh import (infer_pe_links_sharded,
                                                  make_mesh)

    ids, seqs, ksize, reads = hiv_inputs(hiv_out, hiv_data)
    init_distributed(f"file://{WORK}/nccl_store", 1, 0, device="cuda")
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"world of one on cuda: backend {backend}")
        mesh = make_mesh(1, 1, device="cuda")

        def run():
            torch.cuda.synchronize()
            t = time.time()
            res = infer_pe_links_sharded(ids, seqs, reads, ksize, mesh,
                                         batch_size=16384)
            torch.cuda.synchronize()
            return res, time.time() - t

        walls = []
        for i in range(2):
            _, (res, sec) = count_launches(
                f"hiv sharded, NCCL world of 1, call {i + 1}", run, DENSE,
                ("sort_rows", "dup_scan", "dup_stats"))
            walls.append(sec)
            if i == 0:
                first = res
            elif not (np.array_equal(res.node_mat, first.node_mat)
                      and np.array_equal(res.short_mat, first.short_mat)):
                raise AssertionError("hiv sharded: the second call's links "
                                     "differ from the first's")
    finally:
        dist.destroy_process_group()
    out = os.path.join(WORK, "hiv_nccl")
    write_links(first, out, "write_pe_files")
    check_digests("HIV sharded (NCCL world of 1)", out,
                  {"pe_info": hiv["outputs"]["aln/pe_info"],
                   "st_info": hiv["outputs"]["aln/st_info"]})
    say(f"hiv sharded, NCCL world of 1 (mesh 1 x 1): engine {walls[0]:.4f} s "
        f"(first call), {walls[1]:.4f} s (second), the table built in each "
        "call; pe_info/st_info byte-equal to the JAX record")


def rank_jobs(hiv_data: str, hiv_out: str, meta_data: str,
              expected: dict) -> list:
    """Phases 12-14 as one job list that both ranks run in order."""
    hiv = {"pe_info": expected["hiv"]["outputs"]["aln/pe_info"],
           "st_info": expected["hiv"]["outputs"]["aln/st_info"]}
    cells = (("hiv_dense", "sharded", {"hiv": True}, "write_pe_files", hiv,
              DENSE),
             ("repeat_dense", "sharded", {"npz": REPEAT_INPUTS},
              "write_pe_files", expected["repeat"]["outputs"],
              ("window_hashes", "dup_stats", "pair_counts")),
             ("repeat_sparse", "sparse_sharded", {"npz": REPEAT_INPUTS},
              "write_pe_files", expected["repeat"]["outputs"],
              ("window_hashes", "dup_scan", "sort_rows")),
             ("r50k", "sharded", {"npz": R50K_INPUTS},
              "write_pe_files_sparse", expected["r50k"]["outputs"],
              ("window_hashes", "sort_rows")))
    jobs = []
    for data, model in ((2, 1), (1, 2)):
        for name, kind, src, writer, digests, on in cells:
            jobs.append(dict(
                phase=12, name=f"{name} {data}x{model}", kind=kind,
                data=data, model=model, writer=writer, digests=digests,
                on=on, out=os.path.join(WORK, "ranks",
                                        f"{name}_{data}x{model}"),
                hiv_data=hiv_data, hiv_out=hiv_out, **src))
    jobs.append(dict(phase=13, name="hiv multihost", kind="multihost",
                     writer="write_pe_files", digests=hiv, on=DENSE,
                     hiv_data=hiv_data, hiv_out=hiv_out,
                     out=os.path.join(WORK, "ranks", "hiv_multihost")))
    meta = expected["metaviral"]
    jobs.append(dict(phase=13, name="metaviral --per-component",
                     kind="cli", cli=meta["cli"], data_dir=meta_data,
                     digests=meta["outputs"], on=DENSE,
                     out=os.path.join(WORK, "ranks", "metaviral")))
    jobs.append(dict(phase=14, name="sp_window_hashes 100 kb", kind="sp",
                     on=("window_hashes",),
                     out=os.path.join(WORK, "ranks", "sp")))
    jobs.append(dict(phase=14, name="build_table_auto (SP) vs host C++",
                     kind="sp_table", on=("window_hashes",),
                     out=os.path.join(WORK, "ranks", "sp_table")))
    return jobs


def sp_sequence():
    import numpy as np
    rng = np.random.RandomState(14)
    return rng.randint(0, 4, SP_SEQ_LEN).astype(np.uint8)


def sp_table_graph() -> list:
    """A seeded graph for the table-build race: SP_TABLE_NODES short and
    long node sequences, in a shuffled order."""
    import numpy as np
    rng = np.random.RandomState(15)
    n_short, n_long = SP_TABLE_NODES
    lens = np.concatenate([rng.randint(200, 2001, n_short),
                           rng.randint(8192, 60001, n_long)])
    rng.shuffle(lens)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bases[rng.randint(0, 4, n)].tobytes().decode() for n in lens]


def rank_job(job: dict, rank: int, world: int):
    """One job on this rank: the timed call, then its outputs (written
    after the clock stops)."""
    import numpy as np
    import torch

    from vstrains_tpu_torch.parallel import distributed as D
    from vstrains_tpu_torch.parallel import mesh as M

    kind = job["kind"]
    if kind in ("sharded", "sparse_sharded"):
        if job.get("hiv"):
            ids, seqs, k, reads = hiv_inputs(job["hiv_out"], job["hiv_data"])
        else:
            ids, seqs, k, reads = load_workload(job["npz"])
        mesh = M.make_mesh(job["data"], job["model"], device="cuda:0")
        fn = (M.infer_pe_links_sharded if kind == "sharded"
              else M.infer_pe_links_sparse_sharded)
        torch.cuda.synchronize()
        t = time.time()
        res = fn(ids, seqs, reads, k, mesh, batch_size=16384)
        torch.cuda.synchronize()
        wall = time.time() - t
        write_links(res, f"{job['out']}.r{rank}", job["writer"])
        return wall, {"model_rank": mesh.model_rank}
    if kind == "multihost":
        ids, seqs, k, stripe = hiv_inputs(job["hiv_out"], job["hiv_data"],
                                          stripe=(rank, world))
        torch.cuda.synchronize()
        t = time.time()
        res = D.infer_pe_links_multihost(ids, seqs, stripe, k,
                                         batch_size=16384, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.time() - t
        write_links(res, f"{job['out']}.r{rank}", job["writer"])
        return wall, {"stripe_pairs": stripe.num_pairs, "model_rank": 0}
    if kind == "cli":
        from vstrains_tpu_torch import cli
        out = f"{job['out']}.r{rank}"
        argv = [a.replace("{data}", job["data_dir"]).replace("{out}", out)
                for a in job["cli"]] + ["--device", "cuda"]
        t = time.time()
        if cli.main(argv) != 0:
            raise RuntimeError(f"port CLI failed on rank {rank}: {argv}")
        return time.time() - t, {"model_rank": 0}
    if kind == "sp":
        mesh = M.make_mesh(model=1, device="cuda:0")
        torch.cuda.synchronize()
        t = time.time()
        h1, h2, valid = M.sp_window_hashes(sp_sequence(), SP_SPLIT_LEN, mesh)
        torch.cuda.synchronize()
        wall = time.time() - t
        np.savez(f"{job['out']}.r{rank}.npz", h1=h1, h2=h2, valid=valid)
        return wall, {"model_rank": 0}
    if kind == "sp_table":
        from vstrains_tpu_torch.ops.pe_infer import _build_kmer_table
        seqs = sp_table_graph()
        walls = {"sp": [], "host": []}
        for _ in range(2):  # alternated: SP, host C++, SP, host C++
            torch.cuda.synchronize()
            t = time.time()
            sp = M.build_table_auto(seqs, SP_SPLIT_LEN, "cuda:0")
            torch.cuda.synchronize()
            walls["sp"].append(time.time() - t)
            t = time.time()
            host = _build_kmer_table(seqs, SP_SPLIT_LEN)
            walls["host"].append(time.time() - t)
        for f in ("h1_biased", "h2", "node", "offset"):
            if not np.array_equal(getattr(sp, f), getattr(host, f)):
                raise AssertionError(f"build_table_auto rank {rank}: {f} "
                                     "differs from the host C++ build")
        if sp.max_dup != host.max_dup:
            raise AssertionError(f"build_table_auto rank {rank}: max_dup")
        return walls["sp"][-1], {"model_rank": 0, "walls": walls,
                                 "entries": host.num_entries}
    raise ValueError(f"unknown rank job {kind!r}")


# the kernel wrappers of ops/cuda_kernels, by the kernel each launches
WRAPPERS = {"window_hashes_wire": "window_hashes",
            "window_hashes_bytes": "window_hashes",
            "stats_accum": "stats_accum", "pair_counts": "pair_counts",
            "sort_rows": "sort_rows", "dup_scan": "dup_scan",
            "dup_stats": "dup_stats"}


class FirstCalls:
    """While the block runs, keeps the arguments of each kernel wrapper's
    first call at each shape (the wrappers run unchanged): the shapes a
    rank's shard gives each kernel of its path, replayed afterwards
    against the plain versions by `replay_checks`."""

    def __enter__(self):
        from vstrains_tpu_torch.ops import cuda_kernels as ck
        self.calls = {}
        self.real = {n: getattr(ck, n) for n in WRAPPERS}
        for name in WRAPPERS:
            setattr(ck, name, self._spy(name))
        return self.calls

    def _spy(self, name):
        def call(*args):
            shape = " ".join("x".join(map(str, a.shape)) for a in args
                             if hasattr(a, "shape"))
            self.calls.setdefault((name, shape), args)
            return self.real[name](*args)
        return call

    def __exit__(self, *exc):
        from vstrains_tpu_torch.ops import cuda_kernels as ck
        for name, fn in self.real.items():
            setattr(ck, name, fn)


class CollectiveClock:
    """While the block runs, times each collective that parallel/mesh.py
    and parallel/distributed.py call (the card synchronised before and
    after, so the time is the collective's own: host staging and the
    exchange) and counts its calls and the bytes this rank sends."""

    NAMES = {"mesh": ("all_reduce", "all_gather_cat", "all_gather_ragged"),
             "distributed": ("all_reduce",)}

    def __enter__(self):
        import importlib
        self.stats = {"calls": 0, "seconds": 0.0, "bytes": 0}
        self.real = []
        for mod, names in self.NAMES.items():
            m = importlib.import_module(f"vstrains_tpu_torch.parallel.{mod}")
            for name in names:
                fn = getattr(m, name)
                self.real.append((m, name, fn))
                setattr(m, name, self._clocked(fn))
        return self.stats

    def _clocked(self, fn):
        import torch

        def call(x, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, *args, **kw)
            torch.cuda.synchronize()
            self.stats["seconds"] += time.perf_counter() - t
            self.stats["calls"] += 1
            self.stats["bytes"] += int(x.nbytes)
            return out
        return call

    def __exit__(self, *exc):
        for m, name, fn in self.real:
            setattr(m, name, fn)


def replay_checks(calls: dict, label: str) -> list:
    """Each kept call through the kernel and through its plain version
    (pair_counts into fresh zero accumulators): bit-equal, or raise."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    plain = {"window_hashes_bytes": ck.window_hashes_plain,
             "stats_accum": ck.stats_accum_plain,
             "sort_rows": ck.sort_rows_plain, "dup_scan": ck.dup_scan_plain,
             "dup_stats": ck.dup_stats_plain}
    checks = []
    for (name, shape), args in calls.items():
        if name == "pair_counts":
            f, r, acc, _ = args
            z = [torch.zeros_like(acc) for _ in range(4)]
            ck.pair_counts(f, r, z[0], z[1])
            ck.pair_counts_plain(f, r, z[2], z[3])
            got, want = z[:2], z[2:]
        elif name == "window_hashes_wire":
            wire, T, L = args
            got = ck.window_hashes_wire(*args)
            want = ck.window_hashes_plain(*ck.unpack_wire_plain(wire, T), L)
        else:
            got, want = getattr(ck, name)(*args), plain[name](*args)
        kernel = WRAPPERS[name]
        err = max_abs_err(f"{kernel} ({label}, {shape})", got, want)
        checks.append({"kernel": kernel, "shape": f"{label}: {name} {shape}",
                       "max_abs_err": float(err)})
    return checks


def rank_main(rank: int, world: int, init: str, jobs_path: str) -> int:
    """A rank of phases 12-14 (`chip_smoke.py --rank R WORLD INIT JOBS`):
    on cuda:0 beside the other rank, over gloo; each job's launch counts
    set to 0 just before it and read just after, its wall and outputs
    written for the parent to check; then each kernel the job launched,
    at each shape this rank gave it, against its plain version."""
    import torch.distributed as dist

    from vstrains_tpu_torch.ops import _build
    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.parallel.distributed import init_distributed

    _build.load()  # the parent built it: load, do not time, the library
    init_distributed(init, world, rank, device="cuda:0", backend="gloo")
    with open(jobs_path) as fh:
        jobs = json.load(fh)
    for job in jobs:
        ck.reset_launches()
        with FirstCalls() as calls, CollectiveClock() as comm:
            wall, info = rank_job(job, rank, world)
        info.update(wall=wall, launches=dict(ck.LAUNCHES), collectives=comm)
        info["checks"] = replay_checks(calls, f"{job['name']} rank {rank}")
        del calls
        with open(f"{job['out']}.r{rank}.json", "w") as fh:
            json.dump(info, fh)
        say(f"rank {rank}: {job['name']}: {wall:.3f} s, of it "
            f"{comm['seconds']:.3f} s in {comm['calls']} collectives "
            f"sending {comm['bytes'] / 1e6:.1f} MB; launches "
            f"{json.dumps(info['launches'])}; "
            f"{len(info['checks'])} kernel shapes bit-equal to plain")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def rank_world_phase(hiv_data: str, hiv_out: str, meta_data: str,
                     expected: dict) -> dict:
    """(12)-(14) Two ranks spawned on cuda:0 over gloo (`rank_main`): (12)
    the sharded engines at (data, model) = (2, 1) and (1, 2) on HIV
    (dense, packed probe: stats_accum on each shard), the repeat cell
    (dense, classic: dup_stats on each shard; sparse: dup_scan on each
    shard, sort_rows in the TP merge) and the N = 50k cell (sparse,
    262,144 pairs: sort_rows in the tail and the TP merge); (13)
    infer_pe_links_multihost on HIV stripes and --per-component on the
    metaviral sample; (14) sp_window_hashes over both ranks. Every rank's
    outputs byte-equal to the JAX records, each rank's launches checked
    (pair_counts only on model rank 0), and each kernel a rank launched
    held to its plain version at every shape the rank gave it. Returns
    those checks. Two ranks on one card check correctness and each
    shard's kernel shapes, not scaling."""
    import numpy as np

    from vstrains_tpu_torch.core.seq import window_hashes_np

    os.makedirs(os.path.join(WORK, "ranks"))
    jobs = rank_jobs(hiv_data, hiv_out, meta_data, expected)
    jobs_path = os.path.join(WORK, "ranks", "jobs.json")
    with open(jobs_path, "w") as fh:
        json.dump(jobs, fh)
    world = 2
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(world), f"file://{WORK}/ranks/store", jobs_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    world_s = time.time() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{log[-6000:]}")
        for line in log.splitlines():
            if line.startswith(f"rank {r}: "):
                say(line)
    phases = {}
    checks = []
    for job in jobs:
        for r in range(world):
            with open(f"{job['out']}.r{r}.json") as fh:
                info = json.load(fh)
            got = info["launches"]
            on = [k for k in job["on"] if k != "pair_counts"
                  or info["model_rank"] == 0]
            off = [k for k in ALL if k not in on]
            if [k for k in on if got[k] <= 0] or [k for k in off
                                                 if got[k] != 0]:
                raise AssertionError(f"{job['name']} rank {r}: launches "
                                     f"{got}, expected only {on}")
            if job["kind"] == "sp_table":
                say(f"build_table_auto rank {r}: {info['entries']} "
                    "entries, equal to the host C++ build; walls (s) SP "
                    f"{info['walls']['sp']}, host C++ "
                    f"{info['walls']['host']}")
            elif job["kind"] == "sp":
                z = np.load(f"{job['out']}.r{r}.npz")
                want = window_hashes_np(sp_sequence(), SP_SPLIT_LEN)
                for a, b in zip((z["h1"], z["h2"], z["valid"]), want):
                    if a.dtype != b.dtype or not np.array_equal(a, b):
                        raise AssertionError(f"sp_window_hashes rank {r} "
                                             "differs from the host hashes")
            else:
                check_digests(f"{job['name']} rank {r}",
                              f"{job['out']}.r{r}", job["digests"])
            unchecked = [k for k in on if not any(
                c["kernel"] == k for c in info["checks"])]
            if unchecked:
                raise AssertionError(f"{job['name']} rank {r}: no "
                                     f"per-shard check of {unchecked}")
            checks += info["checks"]
            if r == 0:
                phases[job["phase"]] = phases.get(job["phase"], 0.0) + \
                    info["wall"]
        if job["kind"] == "sp_table":
            continue
        say(f"{job['name']}: outputs of both ranks byte-equal to the JAX "
            "record" if job["kind"] != "sp" else
            f"{job['name']}: both ranks' {SP_SEQ_LEN - SP_SPLIT_LEN + 1} "
            "windows equal the host hashes")
    say(f"rank world (2 ranks on one card, gloo): {world_s:.1f} s in all; "
        "rank 0's job walls by phase (s): " + ", ".join(
            f"{k}: {v:.2f}" for k, v in sorted(phases.items())))
    say(f"per-shard kernel checks: {len(checks)} (kernel, rank, shape) "
        "cases bit-equal to plain, by kernel " + json.dumps(
            {k: sum(c["kernel"] == k for c in checks) for k in ALL}))
    return checks


def sp_kernel_check(world: int = 2) -> dict:
    """(14) window_hashes_bytes against its plain version at the shape one
    rank's SP block gives it: the block of SP_SEQ_LEN / world codes with
    its halo, cut into rows of parallel.mesh._SP_ROW_WINDOWS windows."""
    import torch

    from vstrains_tpu_torch.ops import cuda_kernels as ck
    from vstrains_tpu_torch.parallel import mesh as M

    L = SP_SPLIT_LEN
    block = SP_SEQ_LEN // world
    ext = torch.from_numpy(sp_sequence()[:block + L - 1]).cuda()
    W = block
    rows = -(-W // M._SP_ROW_WINDOWS)
    width = M._SP_ROW_WINDOWS + L - 1
    codes = torch.nn.functional.pad(
        ext, (0, rows * M._SP_ROW_WINDOWS + L - 1 - ext.shape[0]),
        value=255).unfold(0, width, M._SP_ROW_WINDOWS).contiguous()
    lens = torch.full((rows,), width, dtype=torch.int32, device="cuda")
    label = f"SP block, {rows} rows x T={width}"
    return dict(compare(
        f"window_hashes ({label}, split_len={L})",
        lambda: ck.window_hashes_bytes(codes, lens, L),
        lambda: ck.window_hashes_plain(codes, lens, L),
        bound_=hash_bound(codes.numel() + 4 * rows, rows, M._SP_ROW_WINDOWS),
        library=NO_LIBRARY_HASH), kernel="window_hashes", shape=label)


_KERNEL_NAMES = ("pair_counts_kernel", "pack_words", "sort_rows_net",
                 "sort_chunk", "sort_global_pass", "sort_cols_net",
                 "stats_accum_shared", "stats_accum_global",
                 "window_hashes_kernel", "dup_scan_kernel",
                 "coo_accum_kernel", "coo_rehash_kernel")


# --------------------------------------------------------------------------
# phase 15: the kernel warm-up layer
# --------------------------------------------------------------------------

# a CLI run in a fresh process (run from the repo's root, so that it
# imports this checkout) whose kernel library lives in the directory
# argv[1] (module state set here, not a knob of the package): empty, the
# run builds the kernels cold; built, it reuses them
_BUILD_DIR_CLI = """
import json, sys
from vstrains_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
from vstrains_tpu_torch import cli
rc = cli.main(json.loads(sys.argv[2]))
info = _build.loaded_info() or {}
print(json.dumps({"rc": rc, "build": {k: v for k, v in info.items()
                                      if k != "log"}}))
"""

_BUILD_LINE = "CUDA kernel library "


def build_line(out_dir: str) -> str:
    """The pipeline's line on the kernel library, from a CLI run's log."""
    with open(os.path.join(out_dir, "vstrains.log")) as fh:
        lines = [x.strip() for x in fh if _BUILD_LINE in x]
    if len(lines) != 1:
        raise AssertionError(f"{out_dir}: {len(lines)} kernel library "
                             "lines in the log, expected 1")
    return lines[0]


def prewarm_hiv(hiv: dict, hiv_data: str, hiv_out: str) -> dict:
    """(15a) `python -m vstrains_tpu_torch.prewarm` on the HIV dataset at
    the CLI run's batch, in a fresh process: exit 0; its nodes and k those
    of the dense HIV CLI run's log, its widths those of that run's batches
    (the pipeline's reads through `_length_buckets`); each width launched
    window_hashes, stats_accum and pair_counts."""
    import re

    from vstrains_tpu_torch.ops import pe_infer as P

    cli = [a.replace("{data}", hiv_data) for a in hiv["cli"]]
    keep = ("-g", "-p", "-fwd", "-rve", "-mc", "-ml", "--pe-batch-size")
    argv = [x for i, a in enumerate(cli) if a in keep
            for x in (a, cli[i + 1])]
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "vstrains_tpu_torch.prewarm",
                        *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"prewarm exited {r.returncode}:\n"
                           f"{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    say(f"prewarm (HIV, fresh process, {wall:.2f} s): {json.dumps(rec)}")

    with open(os.path.join(hiv_out, "vstrains.log")) as fh:
        log = fh.read()
    k = int(re.search(r"graph kmer size: (\d+)", log).group(1))
    nodes = int(re.search(r"kmer table: \d+ entries, max_dup=\d+, (\d+) "
                          "nodes", log).group(1))
    ids, _, ksize, reads = hiv_inputs(hiv_out, hiv_data)
    batch = int(argv[argv.index("--pe-batch-size") + 1])
    buckets = P._length_buckets(reads, ksize + 1, batch)
    widths = ([wd for wd, _ in buckets] if buckets else
              [max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])])
    want = {"nodes": nodes, "k": k, "widths": widths, "batch": batch,
            "engine": "dense", "errors": []}
    got = {key: rec[key] for key in want}
    if got != want or len(ids) != nodes or ksize != k:
        raise AssertionError(f"prewarm {got} != the HIV CLI run's {want}")
    for w in widths:
        missing = [name for name in DENSE
                   if rec["launches"][str(w)].get(name, 0) <= 0]
        if missing:
            raise AssertionError(f"prewarm width {w}: {missing} never "
                                 "launched")
    say(f"prewarm: nodes {nodes}, k {k}, widths {widths} equal the HIV CLI "
        "run's; each width launched " + ", ".join(DENSE))
    return rec


def cold_build_hiv(hiv: dict, hiv_data: str, hiv_out: str) -> dict:
    """(15b) The HIV CLI in a fresh process whose kernel library directory
    is empty (a cold nvcc build on the pipeline's background thread), then
    again in a fresh process on the library it built (reused): outputs
    byte-equal to the JAX record both times; the build's seconds, its
    slowest source, and each run's pe_inference and wait at the join
    (from its log's kernel library line) printed beside phase 5's
    in-process run's."""
    import re

    build_dir = os.path.join(WORK, "cold_build")
    shutil.rmtree(build_dir, ignore_errors=True)
    os.makedirs(build_dir)
    res = {}
    for run in ("cold", "reused", "in-process"):
        # "in-process": phase 5's run, after the smoke's own build
        out = (hiv_out if run == "in-process"
               else os.path.join(WORK, f"hiv_{run}_out"))
        build = ({} if run == "in-process" else
                 run_fresh_cli(hiv, hiv_data, build_dir, out, run)["build"])
        line = build_line(out)
        m = re.search(r"waited ([0-9.]+) s", line)
        if m is None or ("built this run" in line) != (run == "cold"):
            raise AssertionError(f"HIV CLI ({run} build): {line!r}")
        with open(os.path.join(out, "timings.json")) as fh:
            pe_s = {x["stage"]: x["seconds"]
                    for x in json.load(fh)["stages"]}["pe_inference"]
        res[run] = dict(build, pe_inference=pe_s, wait=float(m.group(1)))
        say(f"HIV CLI, {run} build: pe_inference {pe_s:.4f} s; {line}")
    cold = res["cold"]
    src = cold["source_seconds"]
    slow = max(src, key=src.get)
    say(f"cold build: {cold['seconds']:.3f} s, slowest source {slow} "
        f"{src[slow]:.3f} s; per source (s): "
        + json.dumps(dict(sorted(src.items(), key=lambda kv: -kv[1]))))
    say("HIV pe_inference (s), waited at the join (s): " + ", ".join(
        f"{run} {r['pe_inference']:.4f}, {r['wait']:.3f}"
        for run, r in res.items()))
    return res


def run_fresh_cli(hiv: dict, hiv_data: str, build_dir: str, out: str,
                  run: str) -> dict:
    """The HIV CLI in a fresh process on the library directory
    `build_dir`: exit 0, outputs byte-equal to the JAX record, and built
    (run "cold") or reused. Returns the child's record."""
    shutil.rmtree(out, ignore_errors=True)
    argv = [a.replace("{data}", hiv_data).replace("{out}", out)
            for a in hiv["cli"]] + ["--device", "cuda"]
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", _BUILD_DIR_CLI, build_dir,
                        json.dumps(argv)], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"HIV CLI ({run} build) exited {r.returncode}:"
                           f"\n{r.stderr[-3000:]}")
    child = json.loads(r.stdout.strip().splitlines()[-1])
    if child["rc"] != 0 or child["build"].get("built") != (run == "cold"):
        raise AssertionError(f"HIV CLI ({run} build): {child}")
    check_digests(f"HIV output ({run} build)", out, hiv["outputs"])
    say(f"HIV CLI, {run} build: fresh process {wall:.2f} s, outputs "
        "byte-equal to the JAX record")
    return child


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol of csrc/: the kernel
    and, for the row sorter's network, its word type, registers a lane
    and warps a row; for the window hashes, the feed; for dup_stats, the
    counters' branch."""
    import re
    m = re.search(r"sort_rows_netI([jm])Li(\d+)ELi(\d+)E", mangled)
    if m:
        word = "uint32" if m.group(1) == "j" else "uint64"
        return f"sort_rows_net<{word}, P={m.group(2)}, W={m.group(3)}>"
    m = re.search(r"sort_rows_net16I([jm])E", mangled)
    if m:
        word = "uint32" if m.group(1) == "j" else "uint64"
        return f"sort_rows_net<{word}, P=16, W=16>"
    m = re.search(r"sort_chunkI([jm])Li(\d+)E", mangled)
    if m:
        word = "uint32" if m.group(1) == "j" else "uint64"
        return (f"sort_chunk<{word}, "
                f"{'sort' if m.group(2) == '2' else 'merge'}>")
    m = re.search(r"sort_global_passI([jm])Li(\d+)E", mangled)
    if m:
        word = "uint32" if m.group(1) == "j" else "uint64"
        return f"sort_global_pass<{word}, S={m.group(2)}>"
    m = re.search(r"sort_cols_netILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"sort_cols_net<P={m.group(1)}, Wc={m.group(2)}>"
    m = re.search(r"window_hashes_kernelILb([01])E", mangled)
    if m:
        return f"window_hashes_kernel<{('bytes', 'wire')[int(m.group(1))]}>"
    m = re.search(r"dup_stats_kernelILb([01])E", mangled)
    if m:
        return f"dup_stats_kernel<{('global', 'shared')[int(m.group(1))]}>"
    return next((n for n in _KERNEL_NAMES if n in mangled), mangled[:60])


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel: ptxas's registers, barriers and
    spills."""
    import re
    parts = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif name and re.search(r"Used \d+ registers|bytes stack frame",
                                line):
            parts.setdefault(name, []).append(
                line.split("info    :")[-1].strip())
    return [f"ptxas {n}: {'; '.join(p)}" for n, p in parts.items()]


def sass_summary(lib_path: str) -> list:
    """Instruction counts that show the design in the compiled code: the
    tensor-core products (GMMA) of pair_counts; the lane shuffles (SHFL)
    against the shared-memory loads and stores (LDS, STS) of the row
    sorter's network; and for the window hashes the shared-memory loads
    (no power table), the global stores and how many of them are 16-byte
    (STG.128), and the multiply-adds (IMAD, moves excluded); for dup_stats
    and dup_scan the global loads and stores, the shared-memory loads,
    stores and atomics (ATOMS); from cuobjdump, where the toolkit has
    it."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ["sass: cuobjdump not found, no instruction counts"]
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        name = kernel_name(block.split()[0])
        if name.startswith("window_hashes"):
            keys = ("LDS", "STS", "STG", "STG.128", "IMAD", "BAR")
        elif name.startswith(("pair_counts", "sort_rows_net", "sort_chunk",
                              "sort_cols_net")):
            keys = ("HGMMA", "IGMMA", "SHFL", "LDS", "STS", "BAR")
        elif name.startswith("dup_"):
            keys = ("LDG", "STG", "STG.128", "LDS", "STS", "ATOMS", "BAR")
        elif name.startswith("coo_"):
            keys = ("LDG", "MATCH", "ATOMG", "RED", "REDUX", "VOTE")
        else:
            continue
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9.]*)", block, re.M)
        count = {k: sum(op.startswith(k) for op in ops) for k in keys}
        count["STG.128"] = sum(op.startswith("STG") and op.endswith(".128")
                               for op in ops)
        count["IMAD"] = sum(op.startswith("IMAD")
                            and not op.startswith("IMAD.MOV") for op in ops)
        out.append(f"sass {name}: " + ", ".join(
            f"{k} {count[k]}" for k in keys if count[k] or k != "HGMMA"))
    return out


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
    if info["built"]:
        say("build seconds per source (one nvcc each, all at once): "
            + json.dumps(dict(sorted(info["source_seconds"].items(),
                                     key=lambda kv: -kv[1]))))
    for line in ptxas_summary(info["log"]) + sass_summary(info["path"]):
        say(f"  {line}")

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
    import numpy as np
    kres = kernel_phase(os.path.join(
        hiv_data, "assembly_graph_after_simplification.gfa"))
    ragged_shapes()
    say(f"dup_stats / dup_scan ragged shapes: "
        f"{dup_ragged(np.random.RandomState(6))} kernel checks bit-equal "
        "to plain")

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
    launches, wall = count_launches(
        "hiv dense", lambda: run_cli(hiv, hiv_data, hiv_out),
        ("window_hashes", "stats_accum", "pair_counts"),
        ("sort_rows", "dup_scan", "dup_stats", "coo_accum"))
    say(f"hiv: port CLI {wall:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check_digests("HIV output", hiv_out, hiv["outputs"])
    with open(os.path.join(hiv_out, "timings.json")) as fh:
        timings = json.load(fh)
    stages = {s["stage"]: s["seconds"] for s in timings["stages"]}
    used = engine_s = None
    with open(os.path.join(hiv_out, "vstrains.log")) as fh:
        for line in fh:
            if "reads: used=" in line:
                used = int(line.split("used=")[1].split(",")[0])
            if "PE engine: " in line:
                engine_s = float(line.split(" in ")[-1].split()[0])
    say(f"hiv stages (s): {json.dumps(stages)}")
    say(f"hiv PE stage: {used} read pairs in {stages['pe_inference']:.3f} s"
        f" = {used / stages['pe_inference']:.1f} reads/s (pairs per "
        "second, FASTQ load and table build included); engine (probe_mode="
        f"sort, table prebuilt) {engine_s:.4f} s")
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

    # 5a. the dense drain into page-locked host blocks
    pinned_drain_check()

    # 5b. the same graph and reads in every probe mode; the graph passes
    view, hiv_dup = hiv_classic_phase(hiv, hiv_data, hiv_out)
    graph_phase(view)
    # 5c. the k-mer table built on the card
    card_table_check()

    # 6. HIV through the sparse engine
    sparse_launches, sparse_checks = hiv_sparse_phase(
        hiv, hiv_data, np.random.RandomState(2))
    # 6a. the sparse engine's link keys counted on the card
    coo = coo_accum_check()

    # 7. the N = 50,000 cell
    c50 = cell_50k(expected["r50k"], np.random.RandomState(3))

    # 8. the repeat cell, dense and sparse; 9. the N = 300,000 cell
    (rep_dense, rep_sparse, kres["dup_stats"], kres["dup_scan"],
     rep_plane) = repeat_cell(expected["repeat"])
    t0 = time.time()
    _, _, rep64 = repeat64_cell(expected["repeat64"],
                                np.random.RandomState(7))
    say(f"phase 8b (repeat64): {time.time() - t0:.1f} s")
    c300 = cell_300k(expected["r300k"], np.random.RandomState(4))
    # 10. per-component extraction; 11. the sharded engine in an NCCL
    # world of one; 12-14. two ranks on the card over gloo
    torch.cuda.empty_cache()
    t0 = time.time()
    meta_data = metaviral_phase(expected["metaviral"])
    say(f"phase 10 (metaviral --per-component): {time.time() - t0:.1f} s")
    t0 = time.time()
    nccl_world_phase(hiv, hiv_data, hiv_out)
    say(f"phase 11 (sharded engine, NCCL world of 1): "
        f"{time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    shard_checks = rank_world_phase(hiv_data, hiv_out, meta_data, expected)
    sp_check = sp_kernel_check()
    say(f"phases 12-14 (two ranks on one card): {time.time() - t0:.1f} s")
    # 15. the kernel warm-up layer: the prewarm tool, a cold and a reused
    # build in fresh processes
    t0 = time.time()
    prewarm_hiv(hiv, hiv_data, hiv_out)
    cold_build_hiv(hiv, hiv_data, hiv_out)
    say(f"phase 15 (prewarm, cold build): {time.time() - t0:.1f} s")

    launches["sort_rows"] = sparse_launches["sort_rows"]
    launches["coo_accum"] = sparse_launches["coo_accum"]
    launches["dup_stats"] = rep_dense["dup_stats"]
    launches["dup_scan"] = rep_sparse["dup_scan"]
    # each kernel's line: its main-path shape (the HIV dense run's; for
    # sort_rows the N = 50k tail's (key, val) sort; for dup_stats and
    # dup_scan the repeat cell's dense and sparse runs; for sort_cols,
    # which no path calls, 2,048 x 2,048, launches from the HIV dense
    # run: 0), its other shapes under "also"
    kres["sort_rows"] = next(c for c in c50 if c["kernel"] == "sort_rows")
    kres["sort_cols"] = next(c for c in kres["also"]
                             if c["kernel"] == "sort_cols")
    kres["coo_accum"] = coo["checks"][0]
    others = [c for c in kres["also"] if c is not kres["sort_cols"]] + \
        sparse_checks + [c for c in c50 if c is not kres["sort_rows"]] + \
        hiv_dup + c300 + rep64 + [rep_plane, sp_check] + coo["checks"][1:]
    keys = ("shape", "ms", "plain_ms", "library_ms", "library", "bound_ms",
            "bound_by", "entries_walked", "distinct_entries", "table_bytes")
    kernels = []
    for meta in ck.KERNELS:
        m = kres[meta["name"]]
        kernels.append(dict(
            meta, launches=launches[meta["name"]],
            **{k: m.get(k) for k in ("shape", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "bound_rate", "library_ms", "library",
                                     "entries_walked", "distinct_entries",
                                     "table_bytes")},
            also=[{k: c.get(k) for k in keys} for c in others
                  if c["kernel"] == meta["name"]],
            shard_checks=sum(c["kernel"] == meta["name"]
                             for c in shard_checks)))
    shutil.rmtree(WORK, ignore_errors=True)
    say(smi)  # again here, so that the card stays in a cut log's tail
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pinned-drain"]:
        pinned_drain_check()
        sys.exit(0)
    if sys.argv[1:2] == ["--card-table"]:
        from vstrains_tpu_torch.ops import _build
        _build.build()
        say(json.dumps(card_table_check()))
        sys.exit(0)
    if sys.argv[1:2] == ["--coo-accum"]:
        from vstrains_tpu_torch.ops import _build
        os.makedirs(WORK, exist_ok=True)
        built = _build.build()
        for line in ptxas_summary(built["log"]) + sass_summary(
                built["path"]):
            if "coo_" in line:
                say(f"  {line}")
        say(json.dumps(coo_accum_check()))
        sys.exit(0)
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5]))
    sys.exit(main())
