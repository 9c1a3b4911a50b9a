#!/usr/bin/env python3
"""Record the JAX package's output digests for the PyTorch port's checks.

Generates the two datasets the port is held to, runs the JAX CLI
(`python -m vstrains_tpu.cli`) on each with JAX on the CPU, and writes
`tests/data/torch_port_expected.json`:

  * "synth": the verify-recipe dataset of `vstrains_tpu.evals.synth`
    (3 strains, 3 bubbles, 400 pairs per strain, seed 77);
  * "hiv": the full-size 5-strain HIV labmix shape of
    `vstrains_tpu.evals.hivsim.make_hiv_dataset(seed=0)` (773 nodes,
    388,928 pairs of 250 bp);
  * "r50k": the sparse engine's large-graph cell, `bench.synth_workload`
    with 50,000 nodes of 200 bp and 1,048,576 read pairs of 150 bp (seed
    0), packed as tools/realistic_50k.py packs it; the JAX engine
    (`infer_pe_links`, stats_mode="auto", which routes this N to its
    sparse engine) runs on the first 262,144 pairs in this process, and
    the record holds the digests of its `write_pe_files_sparse` files;
  * "repeat": the repeat cell, `tools/repeat_workload.repeat_workload`
    (1,024 nodes of 400 bp in 32 groups that share an 80-bp motif, so
    max_dup is about 32 and the engine takes its classic sort join;
    262,144 pairs of 150 bp; seed 5), all pairs through `infer_pe_links`
    (stats_mode="auto", which keeps N = 1,024 dense at batch 16,384);
    the record holds its `write_pe_files` digests;
  * "repeat64": the same generator with 16 groups of 64 nodes (max_dup
    about 64, so the sparse tail's rows of K x depth = 95 x 64 slots pad
    to 8,192), 262,144 pairs of which the first 65,536 run through
    `infer_pe_links` (stats_mode="auto", dense at N = 1,024); the record
    holds its `write_pe_files` digests;
  * "r300k": `bench.synth_workload` with 300,000 nodes of 200 bp (past
    the packed probe's 2^18 node ids: the sparse engine and the classic
    probe) and 1,048,576 pairs, seed 0; the first 65,536 pairs through
    `infer_pe_links(probe_mode="lookup")`, whose matrices the JAX tests
    hold equal to the sort join's and which skips the join's per-batch
    argsort of the ~134 M padded table entries; `write_pe_files_sparse`
    digests;
  * "metaviral": BASELINE config 5, the 15-strain mixed metaviral sample,
    `vstrains_tpu.evals.synth.make_multi_component_dataset` (3 components
    x 5 strains, 3 bubbles, 300 pairs a strain, abundances 20-100, seed
    3) through the JAX CLI with `--per-component` (one worker) and
    `--pe-batch-size 512`; the per-component stages write no
    gfa/split_graph_final.gfa, so the record holds the other outputs.
The repeat, repeat64 and r300k records also hold the digests of their generated
inputs (`tools/repeat_workload.workload_digests`).

Both generators run in a child process with PYTHONHASHSEED=0:
`hivsim._build_unitigs` numbers its unitigs in the iteration order of a
set of strings, which decides the order of contigs.paths, so the HIV
dataset is reproducible only under a fixed hash seed.

Each entry holds the generator call, the sha256 of every input file, the
sha256 of the compared outputs, the CLI arguments (paths relative to the
dataset directory and the output directory), the planted haplotypes'
digest and, for HIV, the per-strain NGA50 of the JAX output.
`chip_smoke.py` regenerates each dataset with the port's own generator
copies, checks the input digests first (a generator mismatch is then
told apart from a port fault), runs the port CLI and compares the output
digests.

Usage:  JAX_PLATFORMS=cpu python tools/torch_port_expect.py [--workdir DIR]
        [--only synth|hiv|r50k|repeat|repeat64|r300k|metaviral]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_JSON = os.path.join(REPO, "tests", "data", "torch_port_expected.json")

INPUT_FILES = ("assembly_graph_after_simplification.gfa", "contigs.paths",
               "reads_1.fastq", "reads_2.fastq")
OUTPUT_FILES = ("aln/pe_info", "aln/st_info", "gfa/split_graph_final.gfa",
                "strain.fasta", "strain.paths")

SYNTH_KW = dict(num_strains=3, num_bubbles=3, pairs_per_strain=400,
                abundances=[40.0, 70.0, 100.0], contig_mode="split",
                error_rate=0.003, seed=77)
SYNTH_BATCH = 512
HIV_KW = dict(seed=0)
HIV_BATCH = 16384
R50K_KW = dict(n_nodes=50000, node_len=200, n_pairs=1_048_576, seed=0)
R50K_CHECKED_PAIRS = 262_144
R50K_BATCH = 16384
REPEAT_KW = dict(n_groups=32, group_size=32, motif_len=80, tail_len=320,
                 n_pairs=262_144, read_len=150, k=55, seed=5)
REPEAT_BATCH = 16384
REPEAT64_KW = dict(REPEAT_KW, n_groups=16, group_size=64)
REPEAT64_CHECKED_PAIRS = 65_536
R300K_KW = dict(n_nodes=300_000, node_len=200, n_pairs=1_048_576, seed=0)
R300K_CHECKED_PAIRS = 65_536
R300K_BATCH = 16384
METAVIRAL_KW = dict(n_components=3, num_strains=5, num_bubbles=3,
                    pairs_per_strain=300,
                    abundances=[20.0, 40.0, 60.0, 80.0, 100.0], seed=3)
METAVIRAL_BATCH = 512


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def haplotypes_digest(haps) -> str:
    """Order-free digest of a set of sequences."""
    return hashlib.sha256("\n".join(sorted(haps)).encode()).hexdigest()


def cli_args(data_dir: str, out_dir: str, batch: int):
    return ["-a", "spades",
            "-g", os.path.join(data_dir, INPUT_FILES[0]),
            "-p", os.path.join(data_dir, INPUT_FILES[1]),
            "-fwd", os.path.join(data_dir, INPUT_FILES[2]),
            "-rve", os.path.join(data_dir, INPUT_FILES[3]),
            "-o", out_dir, "--pe-batch-size", str(batch)]


_GEN_CODE = """
import json, sys
import vstrains_tpu.evals.{mod} as m
ds = getattr(m, sys.argv[1])(sys.argv[2], **json.loads(sys.argv[3]))
haps = ds.true_haplotypes
print(json.dumps({{"haplotypes": sorted(haps.values() if isinstance(haps, dict)
                                        else haps),
                   "stats": getattr(ds, "stats", None),
                   "n_pairs": getattr(ds, "n_pairs", None)}}))
"""


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def generate(mod: str, fn: str, data_dir: str, kwargs: dict) -> dict:
    """Run a dataset generator in a child process under
    PYTHONHASHSEED=0; returns its haplotypes, stats and pair count."""
    r = subprocess.run([sys.executable, "-c",
                        _GEN_CODE.format(mod=mod), fn, data_dir,
                        json.dumps(kwargs)],
                       env=_env(), capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{mod}.{fn} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _record(name, gen_call, data_dir, out_dir, batch, haps, extra,
            flags=(), outputs=OUTPUT_FILES):
    argv = cli_args(data_dir, out_dir, batch) + list(flags)
    env = _env()
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "vstrains_tpu.cli", *argv],
                       env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"JAX CLI failed on {name}:\n{r.stdout[-3000:]}"
                         f"\n{r.stderr[-3000:]}")
    print(f"# {name}: JAX CLI {time.time() - t0:.1f}s", file=sys.stderr)
    rec = {
        "generator": gen_call,
        "inputs": {f: sha256_file(os.path.join(data_dir, f))
                   for f in INPUT_FILES},
        "outputs": {f: sha256_file(os.path.join(out_dir, f))
                    for f in outputs},
        "cli": [a.replace(data_dir, "{data}").replace(out_dir, "{out}")
                for a in argv],
        "haplotypes_sha256": haplotypes_digest(haps),
    }
    rec.update(extra(out_dir) if extra else {})
    return rec


def record_synth(workdir: str) -> dict:
    data_dir = os.path.join(workdir, "synth_data")
    ds = generate("synth", "make_dataset", data_dir, SYNTH_KW)
    return _record("synth", {"module": "evals.synth.make_dataset",
                             "kwargs": SYNTH_KW},
                   data_dir, os.path.join(workdir, "synth_out"),
                   SYNTH_BATCH, ds["haplotypes"], None)


def record_metaviral(workdir: str) -> dict:
    data_dir = os.path.join(workdir, "metaviral_data")
    ds = generate("synth", "make_multi_component_dataset", data_dir,
                  METAVIRAL_KW)
    rec = _record("metaviral",
                  {"module": "evals.synth.make_multi_component_dataset",
                   "kwargs": METAVIRAL_KW},
                  data_dir, os.path.join(workdir, "metaviral_out"),
                  METAVIRAL_BATCH, ds["haplotypes"], None,
                  flags=("--per-component",),
                  outputs=[f for f in OUTPUT_FILES
                           if f != "gfa/split_graph_final.gfa"])
    rec["strains"] = len(ds["haplotypes"])
    return rec


def nga50_of(out_dir: str, truth_path: str) -> dict:
    from vstrains_tpu.evals.nga50 import load_fasta, nga50_report
    rep = nga50_report(load_fasta(os.path.join(out_dir, "strain.fasta")),
                       load_fasta(truth_path), k=31, min_block=500)
    rep.pop("_aggregate")
    return {r: v["nga50"] for r, v in sorted(rep.items())}


def record_hiv(workdir: str) -> dict:
    data_dir = os.path.join(workdir, "hiv_data")
    ds = generate("hivsim", "make_hiv_dataset", data_dir, HIV_KW)
    truth = os.path.join(data_dir, "true_strains.fasta")
    rec = _record("hiv", {"module": "evals.hivsim.make_hiv_dataset",
                          "kwargs": HIV_KW},
                  data_dir, os.path.join(workdir, "hiv_out"), HIV_BATCH,
                  ds["haplotypes"],
                  lambda out: {"nga50": nga50_of(out, truth)})
    rec["inputs"]["true_strains.fasta"] = sha256_file(truth)
    rec["graph"] = ds["stats"]
    rec["read_pairs"] = ds["n_pairs"]
    return rec


def synth_50k_inputs(pairs: int):
    """(ids, node sequences, k, packed (fc, fl, rc, rl)) of the first
    `pairs` read pairs of the R50K_KW generation."""
    from bench import synth_workload
    from vstrains_tpu.core.fastq import _pack
    refs, fwd, rve, k = synth_workload(**R50K_KW)
    fc, fl = _pack([s.encode() for s in fwd[:pairs]])
    rc, rl = _pack([s.encode() for s in rve[:pairs]])
    return [str(i) for i in range(len(refs))], refs, k, (fc, fl, rc, rl)


def record_r50k(workdir: str) -> dict:
    import logging

    from vstrains_tpu.core.fastq import ReadPairBatch
    from vstrains_tpu.ops.pe_infer import (PESparseResult, infer_pe_links,
                                           write_pe_files_sparse)
    t0 = time.time()
    ids, refs, k, (fc, fl, rc, rl) = synth_50k_inputs(R50K_CHECKED_PAIRS)
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fl))
    print(f"# r50k: inputs {time.time() - t0:.1f}s", file=sys.stderr)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    t0 = time.time()
    res = infer_pe_links(ids, refs, batch, k, batch_size=R50K_BATCH,
                         stats_mode="auto")
    if not isinstance(res, PESparseResult):
        raise SystemExit("r50k: the JAX engine did not take its sparse "
                         "path")
    print(f"# r50k: JAX engine {time.time() - t0:.1f}s", file=sys.stderr)
    out_dir = os.path.join(workdir, "r50k_out")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f) for f in ("pe_info", "st_info")]
    write_pe_files_sparse(res, *paths)
    return {
        "generator": {"function": "bench.synth_workload",
                      "kwargs": R50K_KW,
                      "packing": "vstrains_tpu.core.fastq._pack"},
        "checked_pairs": R50K_CHECKED_PAIRS,
        "batch_size": R50K_BATCH,
        "kmer_size": k,
        "writer": "write_pe_files_sparse",
        "outputs": {os.path.basename(p): sha256_file(p) for p in paths},
        "nonzero_pairs": {"pe_info": int((res.pair_counts != 0).sum()),
                          "st_info": int((res.short_counts != 0).sum())},
    }


def _record_engine(name: str, workdir: str, generator: dict, refs, fwd, rve,
                   k: int, checked: int, batch_size: int, writer: str,
                   probe_mode: str, engine: str) -> dict:
    """The JAX engine (stats_mode="auto") on the first `checked` pairs of
    a generated workload; the digests of the `writer` files and of the
    inputs."""
    import logging

    from tools.repeat_workload import workload_digests
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops import pe_infer as P

    inputs = workload_digests(refs, fwd, rve)
    fc, fl = _pack([s.encode() for s in fwd[:checked]])
    rc, rl = _pack([s.encode() for s in rve[:checked]])
    ids = [str(i) for i in range(len(refs))]
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    t0 = time.time()
    res = P.infer_pe_links(ids, refs, ReadPairBatch(fc, fl, rc, rl, 0, 0,
                                                    len(fl)),
                           k, batch_size=batch_size, stats_mode="auto",
                           probe_mode=probe_mode)
    sparse = isinstance(res, P.PESparseResult)
    if sparse != (engine == "sparse"):
        raise SystemExit(f"{name}: the JAX engine did not take its "
                         f"{engine} path")
    print(f"# {name}: JAX engine {time.time() - t0:.1f}s", file=sys.stderr)
    out_dir = os.path.join(workdir, f"{name}_out")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f) for f in ("pe_info", "st_info")]
    getattr(P, writer)(res, *paths)
    nm = res.pair_counts if sparse else res.node_mat
    sm = res.short_counts if sparse else res.short_mat
    return {
        "generator": generator,
        "inputs": inputs,
        "checked_pairs": checked,
        "batch_size": batch_size,
        "kmer_size": k,
        "probe_mode": probe_mode,
        "stats_mode": "auto",
        "engine": engine,
        "writer": writer,
        "outputs": {os.path.basename(p): sha256_file(p) for p in paths},
        "nonzero_pairs": {"pe_info": int((nm != 0).sum()),
                          "st_info": int((sm != 0).sum())},
    }


def record_repeat(workdir: str, name: str = "repeat", kwargs=REPEAT_KW,
                  checked: int = REPEAT_KW["n_pairs"]) -> dict:
    from tools.repeat_workload import repeat_workload
    from vstrains_tpu.ops.pe_infer import build_kmer_table
    refs, fwd, rve, k = repeat_workload(**kwargs)
    max_dup = build_kmer_table(refs, k + 1).max_dup
    rec = _record_engine(
        name, workdir, {"function": "tools.repeat_workload.repeat_workload",
                        "kwargs": kwargs,
                        "packing": "vstrains_tpu.core.fastq._pack"},
        refs, fwd, rve, k, checked, REPEAT_BATCH, "write_pe_files", "sort",
        "dense")
    rec["max_dup"] = max_dup
    return rec


def record_r300k(workdir: str) -> dict:
    from bench import synth_workload
    refs, fwd, rve, k = synth_workload(**R300K_KW)
    return _record_engine(
        "r300k", workdir, {"function": "bench.synth_workload",
                           "kwargs": R300K_KW,
                           "packing": "vstrains_tpu.core.fastq._pack"},
        refs, fwd, rve, k, R300K_CHECKED_PAIRS, R300K_BATCH,
        "write_pe_files_sparse", "lookup", "sparse")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="where datasets and outputs go [default: a "
                         "fresh temporary directory]")
    ap.add_argument("--only", choices=["synth", "hiv", "r50k", "repeat",
                                       "repeat64", "r300k", "metaviral"],
                    default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_port_expect_")
    os.makedirs(workdir, exist_ok=True)
    rec = {}
    if os.path.exists(OUT_JSON):
        with open(OUT_JSON) as fh:
            rec = json.load(fh)
    if args.only in (None, "synth"):
        rec["synth"] = record_synth(workdir)
    if args.only in (None, "hiv"):
        rec["hiv"] = record_hiv(workdir)
    if args.only in (None, "r50k"):
        rec["r50k"] = record_r50k(workdir)
    if args.only in (None, "repeat"):
        rec["repeat"] = record_repeat(workdir)
    if args.only in (None, "repeat64"):
        rec["repeat64"] = record_repeat(workdir, "repeat64", REPEAT64_KW,
                                        REPEAT64_CHECKED_PAIRS)
    if args.only in (None, "r300k"):
        rec["r300k"] = record_r300k(workdir)
    if args.only in (None, "metaviral"):
        rec["metaviral"] = record_metaviral(workdir)
    rec["compared_outputs"] = list(OUTPUT_FILES)
    rec["recorded_with"] = ("vstrains_tpu on the CPU: the CLI for synth, "
                           "hiv and metaviral, infer_pe_links for r50k, "
                           "repeat, repeat64 and r300k")
    with open(OUT_JSON, "w") as fh:
        json.dump(rec, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {OUT_JSON}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
