"""The node count of the graph that a generator of `hivsim.py` builds for
a seed, without writing anything or drawing reads: the strains' genomes
as the generator evolves them, compacted as it compacts them."""

from __future__ import annotations

from portbench.gen import hivsim


def node_count(generator: str, seed: int, params: dict) -> int:
    km = params.get("km", 56)
    if generator == "make_hiv_dataset":
        genomes, _ = hivsim.simulate_strains(params.get("genome_len", 9719),
                                             seed=seed)
    elif generator == "make_benchmark_dataset":
        shape = dict(hivsim.BENCH_SHAPES[params["shape"]])
        shape.update({k: v for k, v in params.items() if k in shape})
        genomes, _ = hivsim.simulate_random_phylogeny(
            shape["n_strains"], shape["genome_len"], seed=seed,
            branch_rate=shape["branch_rate"])
    else:
        raise ValueError(f"no node count for generator {generator!r}")
    unitigs, _ = hivsim._build_unitigs(genomes, km)
    return len(unitigs)
