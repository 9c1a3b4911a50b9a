"""vstrains-tpu-torch-prewarm: build the CUDA kernel library and launch
one warm batch at each read width of a dataset before the real run.

    vstrains-tpu-torch-prewarm -g graph.gfa -p contigs.paths \
        -fwd fwd.fastq -rve rve.fastq [--pe-batch-size 16384] \
        [--device cuda|cpu]

What persists across processes on the card is the built library alone:
`ops/_build.py` compiles every `csrc/*.cu` with nvcc into
`build/vstrains_tpu_torch/libvt_kernels_<hash>.so` (the hash of the
sources and flags), and any later run loads that file instead of
compiling. A CUDA kernel takes any shape the library was built for, so
there is no compiled executable per shape to keep, and the warm batches
leave nothing behind. What they give is a check, in seconds and before
the sample's run: that this card launches this dataset's widths on the
engine the run will take (dense or sparse), with each width's seconds
and its launches by kernel.

The tool replays the pipeline's host stages 1-3 (parse, canonize,
reindex, threshold, contig paths, simplification: the same calls as
`pipeline.run`) to recover the PE stage's exact node set, k and k-mer
table (built once), predicts the width buckets `ops.pe_infer.
_length_buckets` will form from a 200,000-read head sample of the
library (`plan_widths`), and runs one batch of zero-length read pairs
through `infer_pe_links` at each width in turn. A library whose head is
unlike its tail can make the prediction miss a width: over-predicting
costs one warm batch, and the real run launches a missed width all the
same. A width whose batch raises, or launches no kernel on the card, is
an error (exit code 1); a failed build raises.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import sys
import time
from typing import List

import numpy as np

from vstrains_tpu_torch.algos.preprocess import (graph_simplification,
                                                 reindexing)
from vstrains_tpu_torch.core.canon import load_gfa_canonized
from vstrains_tpu_torch.core.contig_io import spades_paths_parser
from vstrains_tpu_torch.core.fastq import ReadPairBatch
from vstrains_tpu_torch.device import resolve_device
from vstrains_tpu_torch.ops import _build
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops.graph_ops import threshold_estimation
from vstrains_tpu_torch.ops.pe_infer import (build_kmer_table,
                                             dense_budget_rows,
                                             infer_pe_links)

_LOG = logging.getLogger("vstrains_tpu_torch.prewarm")


def _sample_read_widths(path: str, limit: int = 200_000) -> np.ndarray:
    """Lengths of the first `limit` reads (plain or gzip FASTQ)."""
    opener = gzip.open if path.endswith(".gz") else open
    lens: List[int] = []
    with opener(path, "rt") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                lens.append(len(line.strip()))
                if len(lens) >= limit:
                    break
    return np.asarray(lens, np.int32)


def plan_widths(fwd: str, rve: str, split_len: int, batch_size: int,
                est_pairs: int, multiple: int = 32,
                min_frac: float = 0.10) -> List[int]:
    """Predict the width buckets ops.pe_infer._length_buckets will form
    (same rounding/merge rules, computed on a head sample of the
    library). Over-predicting only costs a warm batch; the real run
    launches anything missed."""
    wf = _sample_read_widths(fwd)
    wr = _sample_read_widths(rve)
    n = min(len(wf), len(wr))
    if n == 0:
        return []
    w = np.maximum(wf[:n], wr[:n])
    w = np.maximum(w, split_len)
    t_max = int(-(-int(w.max()) // multiple) * multiple)
    w = np.minimum(-(-w // multiple) * multiple, t_max)
    widths, counts = np.unique(w, return_counts=True)
    if len(widths) == 1 or est_pairs < 4 * batch_size:
        return [t_max]
    kept = [int(wd) for wd, c in zip(widths, counts)
            if c >= min_frac * n or wd == widths[-1]]
    return sorted(set(kept), reverse=True)


def prewarm(args, logger: logging.Logger = None) -> dict:
    """Build (on CUDA), replay stages 1-3, plan the widths and run one
    warm batch at each. `args.device` ("cuda" by default) must exist:
    without a card this raises. Returns the record that `main` prints."""
    logger = logger or _LOG
    device = resolve_device(getattr(args, "device", "cuda"))
    t_start = time.time()
    rec = {"device": str(device), "library": None, "built": False,
           "build_seconds": 0.0, "source_seconds": {}}
    if device.type == "cuda":
        _build.load()
        info = _build.loaded_info()
        rec.update(library=info["path"], built=info["built"],
                   build_seconds=info["seconds"],
                   source_seconds=info["source_seconds"])
        logger.info("prewarm: kernel library %s (%s, %.3f s)",
                    info["path"], "built" if info["built"] else "reused",
                    info["seconds"])

    # stages 1-3, the pipeline's calls, so that the simplified node set
    # (hence k and the k-mer table) is the real run's
    view = load_gfa_canonized(args.gfa_file, logger)
    view0 = view.compact()
    view0, idx_mapping = reindexing(view0)
    if getattr(args, "min_cov", None) is not None:
        threshold = args.min_cov
    else:
        dps = [v.dp for v in view0.graph.vertices()]
        threshold = threshold_estimation(np.array(dps), logger)
    spades_paths_parser(view0, idx_mapping, args.path_file,
                        getattr(args, "min_len", 250) or 250, threshold,
                        logger)
    graph_simplification(view0, None, threshold, logger)
    view1 = view0.compact()
    ids = list(view1.nodes.keys())
    seqs = [view1.nodes[i].seq for i in ids]
    ksize = (next(iter(view1.edges.values())).overlap
             if view1.num_edges() > 0 else 0)
    if ksize <= 0:
        raise RuntimeError("graph has no edges; nothing to prewarm")

    bsz = getattr(args, "pe_batch_size", 16384) or 16384
    fsize = os.path.getsize(args.fwd)
    if args.fwd.endswith(".gz"):
        fsize *= 4
    est_pairs = fsize // 540  # ~bytes per 250bp record; order-of-magnitude
    widths = plan_widths(args.fwd, args.rve, ksize + 1, bsz, est_pairs)
    table = build_kmer_table(seqs, ksize + 1)
    engine = "sparse" if bsz > dense_budget_rows(len(ids)) else "dense"
    logger.info("prewarm: N=%d nodes, k=%d, batch=%d, widths=%s, %s "
                "engine, device %s", len(ids), ksize, bsz, widths, engine,
                device)

    quiet = logging.getLogger("vstrains_tpu_torch.prewarm.worker")
    quiet.setLevel(logging.WARNING)
    errors: List[str] = []
    warm_seconds, launches = {}, {}
    for width in widths:
        zc = np.zeros((bsz, width), np.uint8)
        zl = np.zeros(bsz, np.int32)
        warm = ReadPairBatch(zc, zl, zc, zl, 0, 0, bsz)
        ck.reset_launches()
        t0 = time.time()
        try:
            # the result is copied to the host, so the time includes the
            # device's work
            infer_pe_links(ids, seqs, warm, ksize, batch_size=bsz,
                           table=table, logger=quiet, device=device)
        except Exception as exc:  # report the width, warm the others
            logger.warning("prewarm width %d failed", width, exc_info=True)
            errors.append(f"width {width}: {exc}")
            continue
        warm_seconds[width] = time.time() - t0
        launches[width] = {k: v for k, v in ck.LAUNCHES.items() if v}
        logger.info("prewarm width %d: %.3f s, launches %s", width,
                    warm_seconds[width], launches[width])
        if device.type == "cuda" and not launches[width]:
            logger.warning("prewarm width %d launched no kernel", width)
            errors.append(f"width {width}: no kernel launched")

    rec.update(nodes=len(ids), k=ksize, batch=bsz, widths=widths,
               engine=engine, warm_seconds=warm_seconds, launches=launches,
               wall_seconds=time.time() - t_start, errors=errors)
    logger.info("prewarm done in %.3f s", rec["wall_seconds"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vstrains-tpu-torch-prewarm",
        description="Build the CUDA kernel library and launch one warm "
                    "PE batch at each read width of a dataset before the "
                    "real run; prints the record as one JSON line.")
    ap.add_argument("-g", "--gfa", dest="gfa_file", required=True)
    ap.add_argument("-p", "--paths", dest="path_file", required=True)
    ap.add_argument("-fwd", dest="fwd", required=True)
    ap.add_argument("-rve", dest="rve", required=True)
    ap.add_argument("-mc", "--minimum-coverage", dest="min_cov",
                    type=float, default=None)
    ap.add_argument("-ml", "--minimum-contig-length", dest="min_len",
                    type=int, default=250)
    ap.add_argument("--pe-batch-size", dest="pe_batch_size", type=int,
                    default=16384)
    ap.add_argument("--device", dest="device", default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the warm batches run [default: cuda]")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    rec = prewarm(args)
    print(json.dumps(rec))
    return 1 if rec["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
