"""HIV-labmix-fidelity dataset simulator: a frozen copy for the benchmark.

Copied from `vstrains_tpu_torch/evals/hivsim.py` at commit
bc5e135ef114cb1be5519b7422aa36d058e4b564 (the file last changed in
4016e5f). Its departures, and no others:

  * the unused import of `revcomp_str` (`vstrains_tpu_torch/core/seq.py`)
    is dropped, so that the generator imports nothing of the program;
  * `_build_unitigs` walks the k-mers in sorted order
    (`for w in sorted(all_kmers)`) where the original walks a set, whose
    order follows PYTHONHASHSEED: unitig ids, and with them the contig
    order of `contigs.paths`, are now the same under any hash seed. The
    graph, the contigs and the reads are otherwise the original's;
  * in the text, paths into the reference implementation, VStrains
    (https://github.com/metagentools/VStrains), read "VStrains'
    README.md" and the like.

The original's description follows.
HIV-labmix-fidelity dataset simulator.

The reference's flagship real benchmark is the 5-strain HIV-1 labmix
(SRR961514, 20,000x coverage, strains HXB2/89.6/JR-CSF/NL4-3/YU2;
VStrains' README.md:209-211) scored by MetaQUAST NGA50
(VStrains' evals/quast_evaluation.py:38-60). The raw data cannot
be fetched at run time, so this module simulates its *shape*
with real mutation structure instead of the hand-laid bubble chains of
evals/synth.py:

  * 5 full-length (~9.7kb) strain genomes evolved down a fixed
    phylogeny from one ancestor (nested variation: clade-shared
    substitutions + leaf-private ones, plus short indels), pairwise
    backbone identity >= 90%;
  * an assembly graph constructed the way an assembler would see it —
    a compacted de Bruijn graph over the union of strain (k+1)-mers,
    with coverage = sum of traversing-strain abundances (nothing is
    hand-placed; bubbles, nested bubbles and shared anchors emerge
    from the sequence divergence itself);
  * SPAdes-like contigs: each strain's unitig path fragmented wherever
    phasing is information-theoretically lost (a shared unitig longer
    than the insert size), deduplicated across strains;
  * 2x250bp paired reads at the requested total coverage with an
    Illumina-shaped error profile (3'-degrading substitutions, rare
    indels, N dropouts, Phred+33 qualities tracking the true error
    rate).

All outputs use the same file contract as evals/synth.py, so both this
pipeline and the actual reference (via shims/) run on them unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_B2I = {65: 0, 67: 1, 71: 2, 84: 3}


# --------------------------------------------------------------------------
# phylogeny
# --------------------------------------------------------------------------

# (name, parent, substitutions-per-site on the branch). Shape mirrors a
# small subtype-B tree: two clades, one with a nested split. Pairwise
# leaf divergence lands in ~2-4.5% (identity >= 95%).
_TREE = [
    ("cladeA", "root", 0.010),
    ("cladeB", "root", 0.010),
    ("s1", "cladeA", 0.007),
    ("s2", "cladeA", 0.009),
    ("s3", "cladeB", 0.013),
    ("cladeC", "cladeB", 0.006),
    ("s4", "cladeC", 0.005),
    ("s5", "cladeC", 0.007),
]
_LEAVES = ("s1", "s2", "s3", "s4", "s5")


def _evolve(seq: np.ndarray, rng: np.random.RandomState, sub_rate: float,
            n_indels: int) -> np.ndarray:
    """One branch: iid substitutions at sub_rate plus n_indels short
    indels (3-12bp), on a 0-3 coded array."""
    out = seq.copy()
    hits = np.nonzero(rng.random_sample(len(out)) < sub_rate)[0]
    out[hits] = (out[hits] + rng.randint(1, 4, size=len(hits))) % 4
    for _ in range(n_indels):
        ln = rng.randint(3, 13)
        pos = rng.randint(50, len(out) - 50 - ln)
        if rng.randint(2):
            out = np.concatenate([out[:pos],
                                  rng.randint(0, 4, ln).astype(out.dtype),
                                  out[pos:]])
        else:
            out = np.concatenate([out[:pos], out[pos + ln:]])
    return out


def simulate_strains(genome_len: int = 9719, seed: int = 0,
                     indels_per_branch: int = 3
                     ) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Evolve the 5 leaf genomes; returns ({name: seq}, pairwise min
    identity diagnostics)."""
    rng = np.random.RandomState(seed)
    nodes = {"root": rng.randint(0, 4, genome_len).astype(np.int8)}
    for name, parent, rate in _TREE:
        nodes[name] = _evolve(nodes[parent], rng, rate,
                              rng.randint(1, indels_per_branch + 1))
    genomes = {lf: _BASES[nodes[lf].astype(np.intp)].tobytes().decode()
               for lf in _LEAVES}
    return genomes, _identity_stats(genomes)


def _identity_stats(genomes: Dict[str, str]) -> Dict[str, float]:
    """Approximate pairwise identity via shared-31-mer Jaccard-style
    containment (cheap; only a diagnostic for the >=90% backbone
    claim)."""
    k = 31
    sets = {n: {s[i: i + k] for i in range(len(s) - k + 1)}
            for n, s in genomes.items()}
    names = list(genomes)
    worst, total, cnt = 1.0, 0.0, 0
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            inter = len(sets[a] & sets[b])
            base = min(len(sets[a]), len(sets[b]))
            # shared k-mer fraction ~ identity^k  =>  identity estimate
            ident = (inter / base) ** (1.0 / k) if base else 0.0
            worst = min(worst, ident)
            total += ident
            cnt += 1
    return {"min_pairwise_identity": round(worst, 4),
            "mean_pairwise_identity": round(total / max(cnt, 1), 4)}


# --------------------------------------------------------------------------
# compacted de Bruijn graph
# --------------------------------------------------------------------------

@dataclass
class HivDataset:
    gfa_path: str
    paths_path: str
    fwd_path: str
    rve_path: str
    truth_path: str
    true_haplotypes: Dict[str, str]
    node_names: List[str]
    strain_paths: Dict[str, List[str]]
    k: int
    identity: Dict[str, float]
    n_pairs: int = 0
    stats: Dict[str, float] = field(default_factory=dict)


def _build_unitigs(genomes: Dict[str, str], km: int):
    """Compacted DBG over the union of km-mers of all genomes (forward
    strand — the pipeline's canonization handles strandedness).

    Returns (unitigs: list[str], start_of: {kmer: unitig_idx},
    paths: {strain: [unitig_idx,...]}). Consecutive unitigs overlap by
    km-1 characters, so the GFA is written with k = km-1 (SPAdes edge
    overlap convention, synth.py writes the same shape)."""
    succ: Dict[str, set] = {}
    pred: Dict[str, set] = {}
    starts_forced = set()
    ends_forced = set()
    for seq in genomes.values():
        M = len(seq) - km + 1
        prev = seq[0:km]
        starts_forced.add(prev)
        for i in range(1, M):
            cur = seq[i: i + km]
            succ.setdefault(prev, set()).add(cur)
            pred.setdefault(cur, set()).add(prev)
            prev = cur
        # a genome must end exactly at a unitig boundary, even when
        # another genome continues through its final km-mer
        ends_forced.add(prev)
    all_kmers = set()
    for seq in genomes.values():
        for i in range(len(seq) - km + 1):
            all_kmers.add(seq[i: i + km])

    def _is_start(w: str) -> bool:
        if w in starts_forced:
            return True
        ps = pred.get(w, ())
        if len(ps) != 1:
            return True
        (p,) = ps
        return p in ends_forced or len(succ.get(p, ())) != 1

    unitigs: List[str] = []
    start_of: Dict[str, int] = {}
    member: Dict[str, int] = {}
    for w in sorted(all_kmers):
        if not _is_start(w):
            continue
        uid = len(unitigs)
        chars = [w]
        member[w] = uid
        cur = w
        while True:
            if cur in ends_forced:
                break
            ss = succ.get(cur, ())
            if len(ss) != 1:
                break
            (nxt,) = ss
            if _is_start(nxt) or nxt in member:
                break
            member[nxt] = uid
            chars.append(nxt[-1])
            cur = nxt
        unitigs.append(chars[0] + "".join(chars[1:]))
        start_of[w] = uid
    # strain paths: walk each genome unitig-by-unitig
    paths: Dict[str, List[int]] = {}
    for name, seq in genomes.items():
        path = []
        i = 0
        M = len(seq) - km + 1
        while i < M:
            w = seq[i: i + km]
            uid = start_of.get(w)
            assert uid is not None, (
                f"{name}: position {i} does not start a unitig")
            path.append(uid)
            i += len(unitigs[uid]) - km + 1
        # verify overlap-aware reconstruction
        rec = unitigs[path[0]]
        for uid in path[1:]:
            rec += unitigs[uid][km - 1:]
        assert rec == seq, f"{name}: path does not rebuild the genome"
        paths[name] = path
    return unitigs, paths


def _fragment_contigs(paths: Dict[str, List[int]], unitigs: List[str],
                      km: int, phase_limit: int,
                      max_contig_len: int = 2500):
    """SPAdes-like contigs: each strain path is split at every maximal
    run of SHARED unitigs (used by >= 2 strains) whose overlap-aware
    length exceeds phase_limit; the unspannable shared run becomes its
    own fragment. phase_limit defaults to the read length: a single
    read phases across a shorter shared stretch, while paired-end
    repeat resolution is exactly what fails on near-identical-coverage
    strain mixtures (the gap VStrains exists to fill — its inputs on
    the real labmix are likewise read-scale fragmented contigs).
    Identical fragments across strains are deduplicated (coverages sum
    in the caller), as a real assembler emits one contig for a region
    it cannot phase."""
    use_count: Dict[int, int] = {}
    for p in paths.values():
        for uid in set(p):
            use_count[uid] = use_count.get(uid, 0) + 1

    def _run_len(run: List[int]) -> int:
        return (sum(len(unitigs[u]) for u in run)
                - (len(run) - 1) * (km - 1))

    frags: Dict[Tuple[int, ...], List[str]] = {}
    for name, p in paths.items():
        # partition the path into alternating private / shared segments
        segs: List[Tuple[bool, List[int]]] = []
        for uid in p:
            shared = use_count[uid] > 1
            if segs and segs[-1][0] == shared:
                segs[-1][1].append(uid)
            else:
                segs.append((shared, [uid]))
        cur: List[int] = []
        for shared, run in segs:
            if shared and _run_len(run) > phase_limit:
                if cur:
                    frags.setdefault(tuple(cur), []).append(name)
                frags.setdefault(tuple(run), []).append(name)
                cur = []
            else:
                cur.extend(run)
        if cur:
            frags.setdefault(tuple(cur), []).append(name)
    if max_contig_len <= 0:
        return frags
    # real labmix SPAdes contigs top out around 2-3kb (coverage
    # fluctuation + error-induced breaks); split longer fragments into
    # roughly equal pieces at unitig boundaries, deterministically per
    # node-tuple so cross-strain dedupe is preserved
    out: Dict[Tuple[int, ...], List[str]] = {}
    for nodes_t, users in frags.items():
        total = _run_len(list(nodes_t))
        n_pieces = max(1, -(-total // max_contig_len))
        if n_pieces == 1:
            out.setdefault(nodes_t, []).extend(users)
            continue
        target = total / n_pieces
        piece: List[int] = []
        acc = 0
        for uid in nodes_t:
            piece.append(uid)
            acc += len(unitigs[uid]) - (km - 1 if len(piece) > 1 else 0)
            if acc >= target and uid != nodes_t[-1]:
                out.setdefault(tuple(piece), []).extend(users)
                piece, acc = [], 0
        if piece:
            out.setdefault(tuple(piece), []).extend(users)
    return out


# --------------------------------------------------------------------------
# reads
# --------------------------------------------------------------------------

def _phred(perr: np.ndarray) -> np.ndarray:
    q = np.clip((-10.0 * np.log10(np.maximum(perr, 1e-4))), 2, 40)
    return (q + 33.5).astype(np.uint8)


def _sample_reads(genomes: Dict[str, str], abundances: Dict[str, float],
                  n_pairs: int, read_len: int, rng: np.random.RandomState,
                  fwd_path: str, rve_path: str,
                  sub_rate: float = 0.003, indel_rate: float = 1e-4,
                  n_rate: float = 5e-4,
                  insert_mu: float = 450.0, insert_sd: float = 60.0):
    """Vectorized Illumina-like 2xread_len sampler. Substitutions and
    N-dropouts are applied on a (n, L) code matrix; rare indels shift
    individual reads (python loop over the ~1e-4 fraction affected)."""
    tot = sum(abundances.values())
    # 3'-degrading multiplier, same curve synth.py uses
    pos_mult = 0.4 + 2.8 * (np.arange(read_len) / max(read_len - 1, 1)) ** 2
    base_q = _phred(np.maximum(sub_rate * pos_mult * 0.25, 1e-4))
    err_q = _phred(np.maximum(sub_rate * pos_mult, 1e-3))

    def _corrupt(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = mat.shape[0]
        qual = np.broadcast_to(base_q, mat.shape).copy()
        sub = rng.random_sample(mat.shape) < sub_rate * pos_mult
        mat[sub] = (mat[sub] + rng.randint(1, 4, int(sub.sum()))) % 4
        qual[sub] = np.broadcast_to(err_q, mat.shape)[sub]
        ncall = rng.random_sample(mat.shape) < n_rate * pos_mult
        # indels: whole-read shift at a random cycle (fixed-cycle
        # sequencer semantics: deletion consumes template => here we
        # approximate by shifting the tail and refilling random bases)
        n_ind = rng.poisson(indel_rate * read_len * n)
        for _ in range(n_ind):
            r = rng.randint(n)
            cyc = rng.randint(read_len // 4, read_len)
            if rng.randint(2):
                mat[r, cyc + 1:] = mat[r, cyc:-1]
                mat[r, cyc] = rng.randint(0, 4)
            else:
                mat[r, cyc:-1] = mat[r, cyc + 1:]
                mat[r, -1] = rng.randint(0, 4)
        chars = _BASES[mat.astype(np.intp)]
        chars[ncall] = ord("N")
        qual[ncall] = ord("#")
        return chars, qual

    ridx = 0
    with open(fwd_path, "wb") as f1, open(rve_path, "wb") as f2:
        for name, seq in genomes.items():
            npairs = int(round(n_pairs * abundances[name] / tot))
            if not npairs:
                continue
            g = np.frombuffer(seq.encode(), dtype=np.uint8)
            code = np.zeros(len(g), np.int8)
            for b, v in _B2I.items():
                code[g == b] = v
            ins = np.clip(rng.normal(insert_mu, insert_sd, npairs),
                          read_len, min(700, len(seq))).astype(np.int64)
            pos = (rng.random_sample(npairs)
                   * (len(seq) - ins)).astype(np.int64)
            idx = pos[:, None] + np.arange(read_len)[None, :]
            fmat = code[idx].copy()
            # reverse read: 3' end of the insert, reverse-complemented
            ridx2 = (pos + ins - 1)[:, None] - np.arange(read_len)[None, :]
            rmat = (3 - code[ridx2]).copy()
            fchars, fqual = _corrupt(fmat)
            rchars, rqual = _corrupt(rmat)
            chunk = 8192
            for s in range(0, npairs, chunk):
                e = min(s + chunk, npairs)
                buf1, buf2 = [], []
                for i in range(s, e):
                    rid = ridx + i
                    buf1.append(b"@read%d/1\n%s\n+\n%s\n"
                                % (rid, fchars[i].tobytes(),
                                   fqual[i].tobytes()))
                    buf2.append(b"@read%d/2\n%s\n+\n%s\n"
                                % (rid, rchars[i].tobytes(),
                                   rqual[i].tobytes()))
                f1.write(b"".join(buf1))
                f2.write(b"".join(buf2))
            ridx += npairs
    return ridx


# --------------------------------------------------------------------------
# top-level dataset
# --------------------------------------------------------------------------

def simulate_random_phylogeny(n_strains: int, genome_len: int,
                              seed: int = 0,
                              branch_rate: Tuple[float, float] = (
                                  0.004, 0.012),
                              indels_per_branch: int = 3
                              ) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Evolve n_strains leaf genomes down a RANDOM binary phylogeny
    (repeatedly split a random extant lineage; per-branch substitution
    rates uniform in `branch_rate`) — the generalization of the fixed
    5-leaf HIV tree to the reference's other published mixture sizes
    (6-Polio / 10-HCV / 15-ZIKV / 2-SARS-CoV-2,
    VStrains' README.md:204-211). Nested variation arises the
    same way: clade-shared substitutions accumulate before each split."""
    rng = np.random.RandomState(seed)
    lineages = [rng.randint(0, 4, genome_len).astype(np.int8)]
    while len(lineages) < n_strains:
        parent = lineages.pop(rng.randint(len(lineages)))
        for _ in range(2):
            rate = rng.uniform(*branch_rate)
            lineages.append(_evolve(parent, rng, rate,
                                    rng.randint(1, indels_per_branch + 1)))
    genomes = {f"s{i + 1}": _BASES[lin.astype(np.intp)].tobytes().decode()
               for i, lin in enumerate(lineages)}
    return genomes, _identity_stats(genomes)


def make_strain_dataset(out_dir: str,
                        genomes: Dict[str, str],
                        abundances: Dict[str, float],
                        identity: Dict[str, float],
                        km: int = 56,
                        coverage: float = 20000.0,
                        read_len: int = 250,
                        phase_limit: int = 250,
                        max_contig_len: int = 2500,
                        sub_rate: float = 0.003,
                        indel_rate: float = 1e-4,
                        n_rate: float = 5e-4,
                        seed: int = 0) -> HivDataset:
    """Build the full dataset (graph, contigs, reads, truth) under
    out_dir from pre-evolved strain genomes. coverage is the TOTAL
    mixture coverage, split by `abundances`."""
    os.makedirs(out_dir, exist_ok=True)
    ident = identity
    ab = dict(abundances)
    unitigs, upaths = _build_unitigs(genomes, km)
    k = km - 1

    # node coverage: sum of abundances of traversing strains, scaled so
    # the mixture totals `coverage`
    scale = coverage / sum(ab.values())
    cov = np.zeros(len(unitigs))
    for name, p in upaths.items():
        for uid in p:
            cov[uid] += ab[name] * scale

    order = sorted(range(len(unitigs)),
                   key=lambda u: (-len(unitigs[u]), unitigs[u]))
    name_of = {uid: str(i + 1) for i, uid in enumerate(order)}
    node_names = [name_of[uid] for uid in order]

    gfa_path = os.path.join(out_dir, "assembly_graph_after_simplification.gfa")
    edges = set()
    for p in upaths.values():
        for a, b in zip(p, p[1:]):
            edges.add((a, b))
    with open(gfa_path, "w") as g:
        for uid in order:
            g.write(f"S\t{name_of[uid]}\t{unitigs[uid]}"
                    f"\tDP:f:{cov[uid]:.6f}\n")
        for a, b in sorted(edges, key=lambda e: (int(name_of[e[0]]),
                                                 int(name_of[e[1]]))):
            g.write(f"L\t{name_of[a]}\t+\t{name_of[b]}\t+\t{k}M\n")

    # contigs
    frags = _fragment_contigs(upaths, unitigs, km, phase_limit,
                              max_contig_len)
    paths_path = os.path.join(out_dir, "contigs.paths")
    with open(paths_path, "w") as f:
        cno = 1
        for nodes_t, users in sorted(
                frags.items(), key=lambda kv: (-len(kv[0]), kv[0])):
            ln = (sum(len(unitigs[u]) for u in nodes_t)
                  - (len(nodes_t) - 1) * (km - 1))
            c = sum(ab[u] for u in users) * scale
            names = [name_of[u] for u in nodes_t]
            f.write(f"NODE_{cno}_length_{ln}_cov_{c:.6f}\n")
            f.write(",".join(n + "+" for n in names) + "\n")
            f.write(f"NODE_{cno}_length_{ln}_cov_{c:.6f}'\n")
            f.write(",".join(n + "-" for n in reversed(names)) + "\n")
            cno += 1

    # truth fasta
    truth_path = os.path.join(out_dir, "true_strains.fasta")
    with open(truth_path, "w") as f:
        for name, seq in genomes.items():
            f.write(f">{name} abundance={ab[name]}\n{seq}\n")

    # reads: total pairs so that sum(len*ab) bases / genome_len = coverage
    mean_len = float(np.mean([len(s) for s in genomes.values()]))
    n_pairs = int(round(coverage * mean_len / (2 * read_len)))
    rng = np.random.RandomState(seed + 1)
    fwd_path = os.path.join(out_dir, "reads_1.fastq")
    rve_path = os.path.join(out_dir, "reads_2.fastq")
    written = _sample_reads(genomes, ab, n_pairs, read_len, rng,
                            fwd_path, rve_path, sub_rate=sub_rate,
                            indel_rate=indel_rate, n_rate=n_rate)

    strain_paths = {n: [name_of[u] for u in p] for n, p in upaths.items()}
    return HivDataset(
        gfa_path, paths_path, fwd_path, rve_path, truth_path,
        genomes, node_names, strain_paths, k, ident, written,
        stats={"num_nodes": len(unitigs), "num_edges": len(edges),
               "num_contigs": len(frags),
               "mean_unitig_len": round(float(np.mean(
                   [len(u) for u in unitigs])), 1),
               "coverage": coverage, "read_len": read_len})


def make_hiv_dataset(out_dir: str,
                     genome_len: int = 9719,
                     km: int = 56,
                     coverage: float = 20000.0,
                     read_len: int = 250,
                     abundances: Sequence[float] = (
                         10.0, 15.0, 20.0, 25.0, 30.0),
                     phase_limit: int = 250,
                     max_contig_len: int = 2500,
                     sub_rate: float = 0.003,
                     indel_rate: float = 1e-4,
                     n_rate: float = 5e-4,
                     seed: int = 0) -> HivDataset:
    """The flagship 5-strain HIV labmix shape: fixed subtype-B-like
    phylogeny (_TREE), ~9.7kb genomes, 20,000x. Delegates to
    make_strain_dataset — behavior identical to the round-4 generator
    (same rng consumption, same file contract)."""
    genomes, ident = simulate_strains(genome_len, seed=seed)
    ab = {n: a for n, a in zip(_LEAVES, abundances)}
    return make_strain_dataset(
        out_dir, genomes, ab, ident, km=km, coverage=coverage,
        read_len=read_len, phase_limit=phase_limit,
        max_contig_len=max_contig_len, sub_rate=sub_rate,
        indel_rate=indel_rate, n_rate=n_rate, seed=seed)


# --------------------------------------------------------------------------
# the reference's other published benchmark shapes
# (VStrains' README.md:204-211: savage-benchmark simulated
# mixtures at 20,000x + the 2-strain SARS-CoV-2 wastewater pair at
# 4,000x). Genome lengths are the real virus sizes; divergence ranges
# are simulation parameters chosen to land in each mixture's regime —
# SARS-CoV-2 lineages are near-identical (>99.5%), the savage mixtures
# are 2-7% divergent.
# --------------------------------------------------------------------------

BENCH_SHAPES = {
    "polio6": dict(n_strains=6, genome_len=7440, coverage=20000.0,
                   branch_rate=(0.004, 0.012),
                   abundances=(8.0, 11.0, 14.0, 18.0, 22.0, 27.0)),
    "hcv10": dict(n_strains=10, genome_len=9646, coverage=20000.0,
                  branch_rate=(0.005, 0.014),
                  abundances=(5.0, 6.5, 8.0, 9.5, 11.0, 12.5, 14.0,
                              15.5, 17.0, 18.5)),
    "zikv15": dict(n_strains=15, genome_len=10807, coverage=20000.0,
                   branch_rate=(0.005, 0.014),
                   abundances=(3.0, 3.8, 4.6, 5.4, 6.2, 7.0, 7.8, 8.6,
                               9.4, 10.2, 11.0, 11.8, 12.6, 13.4, 14.2)),
    "sars2": dict(n_strains=2, genome_len=29903, coverage=4000.0,
                  branch_rate=(0.0008, 0.0018),
                  abundances=(35.0, 65.0)),
}


def make_benchmark_dataset(out_dir: str, shape: str, seed: int = 0,
                           coverage: float = None, **overrides
                           ) -> HivDataset:
    """One of the reference's published mixture shapes (BENCH_SHAPES)
    as a ready-to-run dataset; `coverage`/overrides adjust the recipe
    (e.g. a cheap low-coverage variant for tests)."""
    spec = dict(BENCH_SHAPES[shape])
    spec.update(overrides)
    n_strains = spec.pop("n_strains")
    genome_len = spec.pop("genome_len")
    branch_rate = spec.pop("branch_rate")
    abundances = spec.pop("abundances")
    if coverage is not None:
        spec["coverage"] = coverage
    genomes, ident = simulate_random_phylogeny(
        n_strains, genome_len, seed=seed, branch_rate=branch_rate)
    ab = {n: a for n, a in zip(sorted(genomes), abundances)}
    return make_strain_dataset(out_dir, genomes, ab, ident, seed=seed,
                               **spec)
