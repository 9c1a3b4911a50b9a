"""A configuration's dataset, generated from the run's `--seed`.

The frozen generator (`gen/`) makes the whole dataset from the seed:
the strains' genomes down the configuration's phylogeny, the assembly
graph and contigs built from them, and the sample's read pairs. The
node count follows the genomes, and the engine's work grows with its
square, so a configuration may hold it to a band (`nodes`: [lo, hi] in
its `dataset` entry): the generator then takes the first of a sequence
of seeds drawn from `--seed` whose graph has a node count in the band.
Every seed so gets a dataset of its own at the same size; each run logs
its node count and the engine's route. A dataset is cached in
`portbench/.cache/data/<config>-<seed>-<digest>/`, the digest taken over
the generator's sources and the configuration's `dataset` entry, so a
later run of the same seed skips the generation and its writes, and a
changed recipe makes a new directory. The newest `KEEP` datasets of a
configuration are kept; older ones are deleted.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache", "data")
FILES = {"gfa": "assembly_graph_after_simplification.gfa",
         "paths": "contigs.paths", "fwd": "reads_1.fastq",
         "rve": "reads_2.fastq"}
KEEP = 8  # datasets of a configuration kept in the cache


def digest(dataset: dict) -> str:
    h = hashlib.sha256(json.dumps(dataset, sort_keys=True).encode())
    for path in sorted(glob.glob(os.path.join(HERE, "gen", "*.py"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def generator_seed(seed: int) -> int:
    """The seed as the generator takes it: numpy's legacy generator
    takes 0 <= s < 2**32, and the reads are drawn at s + 1."""
    return seed % ((1 << 32) - 1)


def pick_seed(spec: dict, seed: int, tries: int = 256) -> Tuple[int, int]:
    """The generator's seed for run seed `seed`, and the candidates
    tried: the first whose graph has a node count in `spec["nodes"]`."""
    if "nodes" not in spec:
        return generator_seed(seed), 1
    from portbench.gen.nodes import node_count

    lo, hi = spec["nodes"]
    draw = rng(seed)
    cand = generator_seed(seed)
    for n in range(1, tries + 1):
        if lo <= node_count(spec["generator"], cand, spec["params"]) <= hi:
            return cand, n
        cand = int(draw.integers(0, (1 << 32) - 1))
    raise RuntimeError(f"no graph of {lo}-{hi} nodes in {tries} seeds "
                       f"drawn from {seed}")


def dataset(name: str, spec: dict, seed: int, log) -> Dict[str, str]:
    """Paths of the configuration's files for `seed`, generating them if
    absent; the log names the node count."""
    from portbench.gen import hivsim

    out = os.path.join(CACHE, f"{name}-{seed}-{digest(spec)}")
    paths = {k: os.path.join(out, f) for k, f in FILES.items()}
    done = os.path.join(out, "done")
    if os.path.exists(done):
        with open(done) as fh:
            stats = json.load(fh)["stats"]
        os.utime(done)
        log(f"dataset {name} seed {seed}: cached in "
            f"{os.path.relpath(out, HERE)}; {stats}")
        return paths
    part = out + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    t0 = time.time()
    gseed, tries = pick_seed(spec, seed)
    make = getattr(hivsim, spec["generator"])
    ds = make(part, seed=gseed, **spec["params"])
    stats = dict(ds.stats, generator_seed=gseed, tries=tries)
    with open(os.path.join(part, "done"), "w") as fh:
        json.dump({"config": name, "stats": stats,
                   "n_pairs": ds.n_pairs, "k": ds.k}, fh)
    os.replace(part, out)
    size = sum(os.path.getsize(p) for p in paths.values())
    # the written pages reach the disk here, in set-up, not in the window
    t1 = time.time()
    for p in os.listdir(out):
        fd = os.open(os.path.join(out, p), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    log(f"dataset {name} seed {seed}: generated in {t1 - t0:.1f} s, "
        f"{size} bytes written, synced in {time.time() - t1:.1f} s; "
        f"{stats}")
    _evict(name, out)
    return paths


def _evict(name: str, keep: str) -> None:
    """All but the newest `KEEP` datasets of configuration `name`."""
    dirs = []
    for p in glob.glob(os.path.join(CACHE, f"{name}-*", "done")):
        with open(p) as fh:
            if json.load(fh).get("config") == name:
                dirs.append((os.path.getmtime(p), os.path.dirname(p)))
    dirs.sort()
    for _, d in dirs[:-KEEP]:
        if d != keep:
            shutil.rmtree(d, ignore_errors=True)


def rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed % (1 << 64)))


def read_gfa(path: str) -> Tuple[List[str], List[str], int]:
    """The segments' ids and sequences in file order, and k (the links'
    overlap)."""
    ids, seqs, k = [], [], 0
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                ids.append(f[1])
                seqs.append(f[2])
            elif f[0] == "L" and not k:
                k = int(f[5].rstrip("M"))
    return ids, seqs, k
