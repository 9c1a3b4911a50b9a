"""The control of `correct`: the reference put in the program's place
with its k-mer match narrowed to one 32-bit hash, on a cell's own
inputs at its own size, judged by the comparisons and limits a run
uses (a sample's links written and read back as the program's
`aln/pe_info` and `aln/st_info`), so that it has to come out not
correct.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--bits 32] [--device cuda]

The configuration states exact links: a window matches a table entry
when the k-mers are equal. The program matches on two 32-bit hashes
(h1, and the top bits of h2 in the packed probe); the step below it
that would tempt a later change is one 32-bit hash, which lets distinct
k-mers match. The link counters cannot serve: they are int64, the
largest count is about 10^4, and int32 and int16 hold it exactly. For
each seed one JSON line: the seed, the node count, the largest exact
count, `correct`, and each comparison's reading beside its limit. The
benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import check, data, spec  # noqa: E402
from portbench.reference import pe_links, pipeline  # noqa: E402


def log(msg):
    print(f"[control] {msg}", file=sys.stderr, flush=True)


def write_links(path: str, ids, mat) -> None:
    """A link matrix as the program's `aln/` files hold it: `u:v:count`
    lines, nonzero entries."""
    m = mat.cpu().numpy()
    with open(path, "w") as fh:
        for i, j in zip(*m.nonzero()):
            fh.write(f"{ids[i]}:{ids[j]}:{m[i, j]}\n")


def control(cell: spec.Cell, seed: int, bits: int, device, tmp: str) -> dict:
    """The control's readings on the cell's dataset for `seed`, through
    the comparisons and limits of a run, and whether they pass."""
    cfg = cell.config
    paths = data.dataset(cfg["name"], cfg["dataset"], seed, log)
    loop = importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")
    _, seqs, k = data.read_gfa(paths["gfa"])
    reads = pe_links.load_reads(paths["fwd"], paths["rve"], k + 1)
    t0 = time.time()
    if cell.traffic["loop"] == "sample":
        exact = os.path.join(tmp, "exact")
        ids, links = pipeline.run_sample(paths["gfa"], paths["paths"], reads,
                                         exact, device)
        ctl = os.path.join(tmp, "control")
        _, hashed = pipeline.run_sample(paths["gfa"], paths["paths"], reads,
                                        ctl, device, key_bits=bits)
        write_links(os.path.join(ctl, "aln", "pe_info"), ids, hashed.node_mat)
        write_links(os.path.join(ctl, "aln", "st_info"), ids,
                    hashed.short_mat)
        readings = check.sample_checks(ctl, exact, ids, links)
    else:
        links = pe_links.pe_links(seqs, reads, k, device)
        hashed = pe_links.pe_links(seqs, reads, k, device, key_bits=bits)
        readings = {"pe_links_differ": check.links_differ(
            hashed.node_mat, hashed.short_mat, links.node_mat,
            links.short_mat)}
    checks, within = check.verdict(readings, loop.Loop.LIMITS)
    top = max(int(links.node_mat.max()), int(links.short_mat.max()))
    return {"workload": cell.name, "seed": seed, "bits": bits,
            "nodes": len(seqs), "max_count": top, "correct": within,
            "checks": checks, "seconds": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--bits", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    device = torch.device(args.device)
    for seed in [int(s) for s in args.seeds.split(",")]:
        tmp = os.path.join(tempfile.gettempdir(), "portbench-control")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            print(json.dumps(control(cell, seed, args.bits, device, tmp)),
                  flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
