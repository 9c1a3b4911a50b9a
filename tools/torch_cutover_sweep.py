#!/usr/bin/env python3
"""Dense vs sparse PE engine of the PyTorch port on one CUDA card, at
mid-size graphs around the dense/sparse cutover.

    python3 tools/torch_cutover_sweep.py [--ns 1000,2000,4000]
        [--pairs 262144] [--batch 16384] [--out FILE.json]

For each N: `bench.synth_workload(n_nodes=N, node_len=200, n_pairs=...)`
(seed 0), one k-mer table, then `infer_pe_links(device="cuda")` with
stats_mode "dense" and "sparse" in turns (dense, sparse, sparse, dense)
after one warm-up call each, timed on the host clock around a device
synchronize. The two engines' link counts must be equal. The engine's
own cutover (the JAX package's memory rule, `dense_budget_rows`) is
reported beside the times and not changed. Prints one JSON object as the last
line (and writes it to --out). Needs a CUDA card: without one it exits
non-zero.
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


def _coo_dense(keys, counts, n):
    import numpy as np
    out = np.zeros((n, n), np.int64)
    out[keys // n, keys % n] = counts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", default="1000,2000,4000")
    ap.add_argument("--pairs", type=int, default=262144)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_cutover_sweep: CUDA is not available")
    from bench import synth_workload
    from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu_torch.ops import pe_infer as P

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for n in (int(x) for x in args.ns.split(",")):
        refs, fwd, rve, k = synth_workload(n_nodes=n, node_len=200,
                                           n_pairs=args.pairs)
        fc, fl = _pack([s.encode() for s in fwd])
        rc, rl = _pack([s.encode() for s in rve])
        reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, args.pairs)
        ids = [str(i) for i in range(n)]
        table = P.build_kmer_table(refs, k + 1)
        bs = args.batch

        def run(mode, r=reads):
            torch.cuda.synchronize()
            t0 = time.time()
            res = P.infer_pe_links(ids, refs, r, k, batch_size=bs,
                                   stats_mode=mode, table=table,
                                   device="cuda")
            torch.cuda.synchronize()
            return res, time.time() - t0

        warm = ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs], 0, 0, bs)
        run("dense", warm)
        run("sparse", warm)
        secs = {"dense": [], "sparse": []}
        mats = {}
        for mode in ("dense", "sparse", "sparse", "dense"):
            res, sec = run(mode)
            secs[mode].append(sec)
            mats[mode] = ((res.node_mat, res.short_mat) if mode == "dense"
                          else (_coo_dense(res.pair_keys, res.pair_counts,
                                           n),
                                _coo_dense(res.short_keys,
                                           res.short_counts, n)))
        for a, b in zip(mats["dense"], mats["sparse"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"N={n}: dense and sparse links "
                                     "differ")
        budget_rows = P.dense_budget_rows(n)
        row = {"N": n, "pairs": args.pairs, "batch": bs,
               "dense_s": secs["dense"], "sparse_s": secs["sparse"],
               "dense_pairs_per_s": args.pairs / min(secs["dense"]),
               "sparse_pairs_per_s": args.pairs / min(secs["sparse"]),
               "budget_rows": budget_rows,
               "rule_picks": "sparse" if bs > budget_rows else "dense"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    rec = {"card": card, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0), "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
