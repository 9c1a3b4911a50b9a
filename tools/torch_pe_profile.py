#!/usr/bin/env python3
"""Where the PyTorch port's PE engine spends its time, on one CUDA card,
at the full-size HIV labmix shape (773 nodes, 388,928 pairs of 250 bp),
or at the N = 50,000 cell of chip_smoke.py (--r50k).

    python3 tools/torch_pe_profile.py [--out FILE.json] [--data DIR]
        [--batch-size B] [--r50k]

`--batch-size 262144` sends the HIV graph to the sparse engine (the
dense/sparse memory rule); --r50k always takes it (`bench.synth_workload`
with the record's generator arguments, all 1,048,576 pairs, batch
16,384). The record also sums the engine's spans in the profiled call
(`utils/tracing.profiled()`: pe.table_upload, pe.pack, pe.upload,
pe.queue, pe.drain, and the sparse engine's pe.wait and pe.coo).

Generates the dataset with the port's generator (child process under
PYTHONHASHSEED=0) unless --data names one, loads the reads and builds
the k-mer table (both timed on the host clock), runs
`ops.pe_infer.infer_pe_links(device="cuda")` once to warm up, then
  * times it with the host clock around a device synchronize,
  * times the host wire packing alone (`_wire_batches`),
  * runs it under torch.profiler (CPU + CUDA activity) and sums the
    device time by kernel; busy share = device kernel time / wall time.
Prints one JSON object as the last line (and writes it to --out).
Needs a CUDA card; on a machine without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _gen(data_dir: str) -> None:
    code = ("import sys; from vstrains_tpu_torch.evals.hivsim import "
            "make_hiv_dataset; make_hiv_dataset(sys.argv[1], seed=0)")
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, data_dir], env=env,
                   check=True, timeout=600)


def _graph(gfa: str):
    ids, seqs, k = [], [], None
    with open(gfa) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                ids.append(f[1])
                seqs.append(f[2])
            elif f[0] == "L" and k is None:
                k = int(f[5][:-1])
    return ids, seqs, k


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--batch-size", type=int, default=16384)
    ap.add_argument("--r50k", action="store_true",
                    help="profile the N = 50,000 cell instead of HIV")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_pe_profile: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    from vstrains_tpu_torch.core.fastq import (ReadPairBatch, _pack,
                                               load_read_pairs)
    from vstrains_tpu_torch.ops import pe_infer as P
    from vstrains_tpu_torch.utils import tracing

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = os.path.join(REPO, "build", "pe_profile")
    if args.r50k:
        from bench import synth_workload
        with open(os.path.join(REPO, "tests", "data",
                               "torch_port_expected.json")) as fh:
            gen = json.load(fh)["r50k"]["generator"]["kwargs"]
        t0 = time.time()
        seqs, fwd, rve, k = synth_workload(**gen)
        fc, fl = _pack([x.encode() for x in fwd])
        rc, rl = _pack([x.encode() for x in rve])
        reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fl))
        del fwd, rve
        ids = [str(i) for i in range(len(seqs))]
        load_s = time.time() - t0
    else:
        data = args.data or os.path.join(work, "hiv_data")
        if not args.data:
            t0 = time.time()
            _gen(data)
            print(f"# dataset generated in {time.time() - t0:.1f} s",
                  file=sys.stderr)
        ids, seqs, k = _graph(os.path.join(
            data, "assembly_graph_after_simplification.gfa"))
        t0 = time.time()
        reads = load_read_pairs(os.path.join(data, "reads_1.fastq"),
                                os.path.join(data, "reads_2.fastq"), k + 1,
                                pad_to_multiple=32)
        load_s = time.time() - t0
    rec = {"card": smi, "torch": torch.__version__,
           "cell": "r50k" if args.r50k else "hiv", "nodes": len(ids),
           "k": k, "batch_size": args.batch_size}
    rec["fastq_load_s" if not args.r50k else "reads_made_s"] = load_s
    rec["pairs"] = reads.num_pairs
    t0 = time.time()
    table = P.build_kmer_table(seqs, k + 1)
    rec["table_build_s"] = time.time() - t0

    def engine():
        return P.infer_pe_links(ids, seqs, reads, k, table=table,
                                batch_size=args.batch_size, device="cuda")

    t0 = time.time()
    engine()
    torch.cuda.synchronize()
    rec["engine_first_call_s"] = time.time() - t0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        engine()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    rec["engine_wall_s"] = walls
    rec["engine_pairs_per_s"] = reads.num_pairs / min(walls)

    t0 = time.time()
    n_batches = sum(1 for _ in P._wire_batches(reads, args.batch_size))
    rec["host_wire_pack_s"] = time.time() - t0
    rec["batches"] = n_batches

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        engine()
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them report the same time again
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        if evt.key.startswith("pe."):
            continue  # a host span's GPU range, not a kernel
        dt = _device_time_us(evt)
        if dt > 0:
            rows.append({"name": evt.key[:90], "count": evt.count,
                         "device_ms": dt / 1e3})
    rows.sort(key=lambda x: -x["device_ms"])
    busy = sum(x["device_ms"] for x in rows) / 1e3
    rec["profiled_wall_s"] = prof_wall
    rec["device_busy_s"] = busy
    rec["device_busy_share"] = busy / prof_wall if prof_wall else None
    rec["device_time_by_kernel"] = rows[:25]
    spans = tracing.profiled()
    rec["engine_spans"] = {
        name: {"count": sum(1 for s in spans["spans"] if s[0] == name),
               "s": ns * 1e-9}
        for name, ns in sorted(spans["span_ns"].items())}
    for x in rows[:25]:
        print(f"{x['device_ms']:10.3f} ms  x{x['count']:<5d} {x['name']}")
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
