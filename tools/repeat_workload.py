"""A repeat-rich paired-end workload: node groups that share a motif.

    from tools.repeat_workload import repeat_workload
    refs, fwd, rve, k = repeat_workload()

`n_groups` groups of `group_size` nodes; every node is its group's
`motif_len`-bp motif followed by a `tail_len`-bp tail of its own, so each
(k+1)-mer inside a motif occurs once per node of its group: the table's
longest duplicate run (`max_dup`) is about `group_size`. With the defaults
(32 groups of 32 nodes of 400 bp) that is past the 16 duplicate ranks of
the packed-payload ("sortfill") probe, and the PE engines of both packages
serve the graph with their classic sort join. Read pairs are sampled as
`bench.synth_workload` samples them: each end uniform over nodes and over
start positions, forward strand.

numpy only (no jax, no torch): the JAX package's record
(tools/torch_port_expect.py --only repeat) and the port's chip run
(chip_smoke.py) draw the same data from it.
"""

from __future__ import annotations

import hashlib

import numpy as np


def workload_digests(refs, fwd, rve) -> dict:
    """sha256 of the node sequences and of each read end, one per line:
    the input digests of a generated workload's record."""
    return {name: hashlib.sha256("\n".join(seqs).encode()).hexdigest()
            for name, seqs in (("nodes", refs), ("reads_1", fwd),
                               ("reads_2", rve))}


def repeat_workload(n_groups: int = 32, group_size: int = 32,
                    motif_len: int = 80, tail_len: int = 320,
                    n_pairs: int = 262_144, read_len: int = 150,
                    k: int = 55, seed: int = 5):
    """Returns (node sequences, forward reads, reverse reads, k)."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    node_len = motif_len + tail_len
    refs = []
    for _ in range(n_groups):
        motif = bases[rng.randint(0, 4, motif_len)].tobytes().decode()
        tails = bases[rng.randint(0, 4, (group_size, tail_len))]
        refs += [motif + t.tobytes().decode() for t in tails]
    n_nodes = len(refs)
    which1 = rng.randint(0, n_nodes, size=n_pairs)
    which2 = rng.randint(0, n_nodes, size=n_pairs)
    pos1 = rng.randint(0, node_len - read_len, size=n_pairs)
    pos2 = rng.randint(0, node_len - read_len, size=n_pairs)
    fwd = [refs[w][p: p + read_len] for w, p in zip(which1, pos1)]
    rve = [refs[w][p: p + read_len] for w, p in zip(which2, pos2)]
    return refs, fwd, rve, k
