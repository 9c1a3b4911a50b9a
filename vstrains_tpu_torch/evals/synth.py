"""Synthetic viral-quasispecies dataset generator.

Builds a SPAdes-like bubble-chain assembly graph for S strains sharing
anchor segments and differing in variant segments, plus contigs.paths and
paired-end FASTQ reads sampled from the true haplotypes. Used by the test
suite (golden E2E recovery of known haplotypes) and by bench.py to
synthesize arbitrarily large read workloads.

The reference repo has no test data generator; its evaluation leans on
external simulated datasets (reference README.md:201-211).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from vstrains_tpu_torch.core.seq import revcomp_str

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng: np.random.RandomState, n: int) -> str:
    return _BASES[rng.randint(0, 4, size=n)].tobytes().decode()


@dataclass
class SynthDataset:
    gfa_path: str
    paths_path: str
    fwd_path: str
    rve_path: str
    true_haplotypes: List[str]
    node_names: List[str]
    k: int


def make_dataset(out_dir: str,
                 num_strains: int = 2,
                 num_bubbles: int = 3,
                 anchor_len: int = 200,
                 variant_len: int = 120,
                 k: int = 21,
                 read_len: int = 60,
                 insert_len: int = 150,
                 pairs_per_strain: int = 600,
                 abundances: Tuple[float, ...] = None,
                 contig_mode: str = "full",
                 error_rate: float = 0.0,
                 indel_rate: float = 0.0,
                 n_rate: float = 0.0,
                 quality_model: str = "uniform",
                 seed: int = 0) -> SynthDataset:
    """Create GFA + contigs.paths + paired FASTQ under out_dir.

    Graph layout: anchor_0 -> {variant_0^s} -> anchor_1 -> ... ->
    anchor_B. Consecutive nodes overlap by exactly k characters (de
    Bruijn-style), and all variants of a bubble share their first/last k
    characters so the junctions are well-defined.

    contig_mode: 'full' emits one contig per strain covering its whole
    path; 'split' emits per-bubble fragments (anchor, variant, anchor) to
    exercise disentanglement + extension harder.

    Read error model (all off by default for the clean golden tests):
      error_rate  — per-base substitution probability;
      indel_rate  — per-base insertion/deletion probability (split
                    evenly; reads stay fixed-length by consuming extra
                    template on deletion / clipping on insertion, like a
                    fixed-cycle sequencer);
      n_rate      — per-base no-call probability ('N', quality '#');
                    occasionally emitted as short runs like real basecall
                    dropouts (the reference discards any read containing
                    N — PE_Inference.py:158-163);
      quality_model — 'uniform' writes flat 'I' quality; 'degrading'
                    scales all error rates up toward the 3' end
                    (Illumina-style) and writes Phred+33 qualities that
                    track the actual per-position error probability, so
                    quality-driven trimming (evals.sampling.quality_trim)
                    has real signal to work with.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    if abundances is None:
        abundances = tuple(40.0 + 30.0 * i for i in range(num_strains))

    # ---- build segments ----
    anchors = []
    for b in range(num_bubbles + 1):
        anchors.append(_rand_seq(rng, anchor_len))
    variants: List[List[str]] = []  # [bubble][strain]
    for b in range(num_bubbles):
        head = anchors[b][-k:]
        tail = anchors[b + 1][:k]
        vs = []
        mid_len = variant_len - 2 * k
        assert mid_len > 4
        base_mid = _rand_seq(rng, mid_len)
        for s in range(num_strains):
            mid = list(base_mid)
            # distinct point mutations per strain (positions spread out)
            npos = 3
            for m in range(npos):
                pos = (m + 1) * mid_len // (npos + 1) + s
                pos = min(pos, mid_len - 1)
                old = mid[pos]
                mid[pos] = "ACGT"[("ACGT".index(old) + 1 + s) % 4]
            vs.append(head + "".join(mid) + tail)
        variants.append(vs)

    # ---- true haplotypes ----
    true_haps = []
    for s in range(num_strains):
        hap = anchors[0]
        for b in range(num_bubbles):
            hap += variants[b][s][k:]          # variant minus head overlap
            hap += anchors[b + 1][k:]          # anchor minus head overlap
        true_haps.append(hap)

    # ---- GFA ----
    node_names = []
    seqs = {}
    covs = {}
    tot = float(sum(abundances))
    for b in range(num_bubbles + 1):
        name = str(len(node_names) + 1)
        node_names.append(name)
        seqs[name] = anchors[b]
        covs[name] = tot
    var_names: List[List[str]] = []
    for b in range(num_bubbles):
        row = []
        for s in range(num_strains):
            name = str(len(node_names) + 1)
            node_names.append(name)
            seqs[name] = variants[b][s]
            covs[name] = float(abundances[s])
            row.append(name)
        var_names.append(row)

    anchor_names = node_names[: num_bubbles + 1]
    gfa_path = os.path.join(out_dir, "assembly_graph_after_simplification.gfa")
    with open(gfa_path, "w") as g:
        for name in node_names:
            g.write(f"S\t{name}\t{seqs[name]}\tDP:f:{covs[name]}\n")
        for b in range(num_bubbles):
            for s in range(num_strains):
                g.write(f"L\t{anchor_names[b]}\t+\t{var_names[b][s]}\t+"
                        f"\t{k}M\n")
                g.write(f"L\t{var_names[b][s]}\t+\t{anchor_names[b + 1]}"
                        f"\t+\t{k}M\n")

    # ---- contigs.paths ----
    def strain_path_nodes(s: int) -> List[str]:
        p = [anchor_names[0]]
        for b in range(num_bubbles):
            p.append(var_names[b][s])
            p.append(anchor_names[b + 1])
        return p

    paths_path = os.path.join(out_dir, "contigs.paths")
    with open(paths_path, "w") as f:
        cno = 1
        records = []
        if contig_mode == "full":
            for s in range(num_strains):
                records.append((strain_path_nodes(s), len(true_haps[s]),
                                abundances[s]))
        else:
            for b in range(num_bubbles):
                for s in range(num_strains):
                    nodes = [anchor_names[b], var_names[b][s],
                             anchor_names[b + 1]]
                    ln = (len(anchors[b]) + len(variants[b][s])
                          + len(anchors[b + 1]) - 2 * k)
                    records.append((nodes, ln, abundances[s]))
        for nodes, ln, cov in records:
            f.write(f"NODE_{cno}_length_{ln}_cov_{cov}\n")
            f.write(",".join(n + "+" for n in nodes) + "\n")
            f.write(f"NODE_{cno}_length_{ln}_cov_{cov}'\n")
            f.write(",".join(n + "-" for n in reversed(nodes)) + "\n")
            cno += 1

    # ---- paired-end reads ----
    fwd_path = os.path.join(out_dir, "reads_1.fastq")
    rve_path = os.path.join(out_dir, "reads_2.fastq")
    flat_qual = "I" * read_len
    noisy = error_rate > 0 or indel_rate > 0 or n_rate > 0
    # 'degrading' multiplies the error rates by 0.4..3.2 from 5' to 3'
    # (a mild Illumina-shaped curve) and writes matching Phred+33 quals
    pos_mult = np.ones(read_len)
    if quality_model == "degrading":
        pos_mult = 0.4 + 2.8 * (np.arange(read_len) / max(read_len - 1,
                                                          1)) ** 2

    def _qual_from_perr(perr: np.ndarray) -> str:
        q = np.clip((-10.0 * np.log10(np.maximum(perr, 1e-4))).astype(
            np.int32), 2, 40)
        return "".join(chr(33 + int(x)) for x in q)

    def mutate(template: str) -> Tuple[str, str]:
        """Apply the error model to a template window; returns
        (read of exactly read_len, quality string)."""
        if not noisy and quality_model == "uniform":
            return template[:read_len], flat_qual
        if indel_rate <= 0 and n_rate <= 0:
            # substitution-only fast path, vectorized (the 1M-pair bench
            # datasets live here); consumes the same rng stream as the
            # round-2 generator under quality_model='uniform'
            arr = list(template[:read_len])
            thresh = error_rate * pos_mult[: len(arr)]
            rs = rng.random_sample(len(arr))
            hits = np.nonzero(rs < thresh)[0]
            for pos in hits:
                old = arr[pos]
                arr[pos] = "ACGT"[("ACGT".index(old)
                                   + rng.randint(1, 4)) % 4]
            read = "".join(arr)
            if quality_model == "uniform":
                return read, "I" * len(read)
            perr = np.maximum(thresh * 0.25, 1e-4)
            perr[hits] = np.maximum(thresh[hits], 1e-3)
            return read, _qual_from_perr(perr)
        out = []
        perr = []
        ti = 0
        while len(out) < read_len and ti < len(template):
            cyc = len(out)
            m = pos_mult[cyc]
            r = rng.random_sample()
            p_sub = error_rate * m
            p_ins = indel_rate * 0.5 * m
            p_del = indel_rate * 0.5 * m
            p_n = n_rate * m
            base = template[ti]
            if r < p_del:
                ti += 1                      # skip a template base
                continue
            if r < p_del + p_ins:
                out.append("ACGT"[rng.randint(0, 4)])   # no ti advance
                perr.append(max(p_sub + p_ins, 1e-3))
                continue
            if r < p_del + p_ins + p_n:
                # no-calls come as short runs like real dropouts
                run = 1 + (rng.randint(0, 3) if rng.random_sample() < 0.3
                           else 0)
                for _ in range(run):
                    if len(out) >= read_len:
                        break
                    out.append("N")
                    perr.append(0.75)
                    ti += 1
                continue
            if r < p_del + p_ins + p_n + p_sub:
                out.append("ACGT"[("ACGT".index(base)
                                   + rng.randint(1, 4)) % 4])
                perr.append(max(p_sub, 1e-3))
            else:
                out.append(base)
                perr.append(max(p_sub * 0.25, 1e-4))
            ti += 1
        read = "".join(out)
        if quality_model == "uniform":
            return read, "I" * len(read)
        return read, _qual_from_perr(np.asarray(perr))

    # deletions consume extra template; hand mutate() a slack window
    slack = read_len + (20 if indel_rate > 0 else 0)

    with open(fwd_path, "w") as f1, open(rve_path, "w") as f2:
        ridx = 0
        for s in range(num_strains):
            hap = true_haps[s]
            npairs = int(pairs_per_strain * abundances[s] / abundances[0])
            maxp = len(hap) - max(insert_len, slack)
            positions = rng.randint(0, maxp, size=npairs)
            for p in positions:
                fseq, fq = mutate(hap[p: p + slack])
                # the reverse read's template grows toward LOWER hap
                # coordinates after revcomp; its 5' base stays at
                # p+insert_len-1 exactly as in the clean model
                rseq, rq = mutate(revcomp_str(
                    hap[max(0, p + insert_len - slack): p + insert_len]))
                f1.write(f"@read{ridx}/1\n{fseq}\n+\n{fq}\n")
                f2.write(f"@read{ridx}/2\n{rseq}\n+\n{rq}\n")
                ridx += 1

    return SynthDataset(gfa_path, paths_path, fwd_path, rve_path,
                        true_haps, node_names, k)


def make_adversarial_dataset(out_dir: str,
                             num_strains: int = 4,
                             num_bubbles: int = 4,
                             nested_every: int = 0,
                             anchor_len: int = 200,
                             variant_len: int = 120,
                             k: int = 21,
                             read_len: int = 60,
                             insert_len: int = 150,
                             pairs_per_strain: int = 600,
                             abundances: Tuple[float, ...] = None,
                             seed: int = 0) -> SynthDataset:
    """Adversarial-topology generator for the recovery-frontier soak.

    Same bubble-chain skeleton as make_dataset, but every
    `nested_every`-th bubble is NESTED: strains first fork into
    groups (outer variant nodes, one per pair of strains), then each
    group forks into per-strain inner variants —
        anchor -> O_g -> I_s -> anchor
    — the topology class where greedy per-branch splitting must resolve
    two stacked decisions whose PE evidence partially overlaps. Shared-
    segment ratio and abundance gaps come from anchor_len/variant_len
    and `abundances` as usual. Contigs are per-bubble fragments (the
    hard 'split' mode). nested_every=0 disables nesting (then this is
    make_dataset with contig_mode='split')."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    if abundances is None:
        abundances = tuple(40.0 + 30.0 * i for i in range(num_strains))

    anchors = [_rand_seq(rng, anchor_len)
               for _ in range(num_bubbles + 1)]
    group_of = [s // 2 for s in range(num_strains)]
    n_groups = max(group_of) + 1

    # per-bubble node sequences; nested bubbles split the variant
    # region into an outer (group) half and an inner (strain) half
    node_names: List[str] = []
    seqs = {}
    covs = {}
    tot = float(sum(abundances))

    def new_node(seq: str, cov: float) -> str:
        name = str(len(node_names) + 1)
        node_names.append(name)
        seqs[name] = seq
        covs[name] = cov
        return name

    anchor_names = [new_node(a, tot) for a in anchors]

    edges: List[Tuple[str, str]] = []
    # per strain, the chain of variant nodes inside bubble b
    bubble_chain: List[List[List[str]]] = []   # [bubble][strain] -> nodes
    for b in range(num_bubbles):
        head = anchors[b][-k:]
        tail = anchors[b + 1][:k]
        nested = nested_every > 0 and (b % nested_every == 0)
        chains: List[List[str]] = [None] * num_strains
        if not nested:
            mid_len = variant_len - 2 * k
            assert mid_len > 4
            base_mid = _rand_seq(rng, mid_len)
            for s in range(num_strains):
                mid = list(base_mid)
                for m in range(3):
                    pos = min((m + 1) * mid_len // 4 + s, mid_len - 1)
                    mid[pos] = "ACGT"[("ACGT".index(mid[pos]) + 1 + s)
                                      % 4]
                node = new_node(head + "".join(mid) + tail,
                                float(abundances[s]))
                edges.append((anchor_names[b], node))
                edges.append((node, anchor_names[b + 1]))
                chains[s] = [node]
        else:
            half = max(k + 5, (variant_len - 2 * k) // 2)
            base_outer = _rand_seq(rng, half)
            base_inner = _rand_seq(rng, half)
            outer_nodes = []
            for g in range(n_groups):
                mid = list(base_outer)
                for m in range(3):
                    pos = min((m + 1) * half // 4 + g, half - 1)
                    mid[pos] = "ACGT"[("ACGT".index(mid[pos]) + 1 + g)
                                      % 4]
                g_cov = float(sum(abundances[s]
                                  for s in range(num_strains)
                                  if group_of[s] == g))
                node = new_node(head + "".join(mid), g_cov)
                outer_nodes.append(node)
                edges.append((anchor_names[b], node))
            for s in range(num_strains):
                g = group_of[s]
                join = seqs[outer_nodes[g]][-k:]
                mid = list(base_inner)
                for m in range(3):
                    pos = min((m + 1) * half // 4 + s, half - 1)
                    mid[pos] = "ACGT"[("ACGT".index(mid[pos]) + 1 + s)
                                      % 4]
                node = new_node(join + "".join(mid) + tail,
                                float(abundances[s]))
                edges.append((outer_nodes[g], node))
                edges.append((node, anchor_names[b + 1]))
                chains[s] = [outer_nodes[g], node]
        bubble_chain.append(chains)

    # ---- true haplotypes ----
    true_haps = []
    for s in range(num_strains):
        hap = anchors[0]
        for b in range(num_bubbles):
            for node in bubble_chain[b][s]:
                hap += seqs[node][k:]
            hap += anchors[b + 1][k:]
        true_haps.append(hap)

    gfa_path = os.path.join(out_dir,
                            "assembly_graph_after_simplification.gfa")
    with open(gfa_path, "w") as g:
        for name in node_names:
            g.write(f"S\t{name}\t{seqs[name]}\tDP:f:{covs[name]}\n")
        seen = set()
        for u, v in edges:
            if (u, v) not in seen:
                seen.add((u, v))
                g.write(f"L\t{u}\t+\t{v}\t+\t{k}M\n")

    # ---- per-bubble fragment contigs ----
    paths_path = os.path.join(out_dir, "contigs.paths")
    with open(paths_path, "w") as f:
        cno = 1
        for b in range(num_bubbles):
            for s in range(num_strains):
                nodes = ([anchor_names[b]] + bubble_chain[b][s]
                         + [anchor_names[b + 1]])
                ln = sum(len(seqs[n]) for n in nodes) \
                    - k * (len(nodes) - 1)
                cov = abundances[s]
                f.write(f"NODE_{cno}_length_{ln}_cov_{cov}\n")
                f.write(",".join(n + "+" for n in nodes) + "\n")
                f.write(f"NODE_{cno}_length_{ln}_cov_{cov}'\n")
                f.write(",".join(n + "-" for n in reversed(nodes))
                        + "\n")
                cno += 1

    # ---- reads (clean; the frontier isolates topology/abundance) ----
    fwd_path = os.path.join(out_dir, "reads_1.fastq")
    rve_path = os.path.join(out_dir, "reads_2.fastq")
    qual = "I" * read_len
    with open(fwd_path, "w") as f1, open(rve_path, "w") as f2:
        ridx = 0
        for s in range(num_strains):
            hap = true_haps[s]
            npairs = int(pairs_per_strain * abundances[s]
                         / abundances[0])
            maxp = len(hap) - insert_len
            positions = rng.randint(0, maxp, size=npairs)
            for p in positions:
                fseq = hap[p: p + read_len]
                rseq = revcomp_str(hap[p + insert_len - read_len:
                                       p + insert_len])
                f1.write(f"@read{ridx}/1\n{fseq}\n+\n{qual}\n")
                f2.write(f"@read{ridx}/2\n{rseq}\n+\n{qual}\n")
                ridx += 1

    return SynthDataset(gfa_path, paths_path, fwd_path, rve_path,
                        true_haps, node_names, k)


def make_multi_component_dataset(out_dir: str, n_components: int = 2,
                                 seed: int = 0,
                                 **kwargs) -> SynthDataset:
    """metaSPAdes-style multi-component mixture: n independent viral
    samples merged into one GFA / contigs.paths / read set, with disjoint
    node namespaces (BASELINE.json config 5)."""
    os.makedirs(out_dir, exist_ok=True)
    sub = []
    for ci in range(n_components):
        d = os.path.join(out_dir, f"comp{ci}")
        sub.append(make_dataset(d, seed=seed + 17 * ci, **kwargs))

    gfa_path = os.path.join(out_dir, "assembly_graph_after_simplification.gfa")
    paths_path = os.path.join(out_dir, "contigs.paths")
    fwd_path = os.path.join(out_dir, "reads_1.fastq")
    rve_path = os.path.join(out_dir, "reads_2.fastq")

    def off_name(name: str, ci: int) -> str:
        return str(int(name) + 1000 * ci)

    all_names: List[str] = []
    all_haps: List[str] = []
    with open(gfa_path, "w") as g:
        for ci, ds in enumerate(sub):
            with open(ds.gfa_path) as f:
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    if fields[0] == "S":
                        fields[1] = off_name(fields[1], ci)
                        all_names.append(fields[1])
                    elif fields[0] == "L":
                        fields[1] = off_name(fields[1], ci)
                        fields[3] = off_name(fields[3], ci)
                    g.write("\t".join(fields) + "\n")
            all_haps.extend(ds.true_haplotypes)

    with open(paths_path, "w") as p:
        cno_off = 0
        for ci, ds in enumerate(sub):
            max_cno = 0
            with open(ds.paths_path) as f:
                for line in f:
                    if line.startswith("NODE_"):
                        parts = line.split("_")
                        cno = int(parts[1])
                        max_cno = max(max_cno, cno)
                        parts[1] = str(cno + cno_off)
                        p.write("_".join(parts))
                    else:
                        nodes = line.strip().split(",")
                        renamed = [off_name(n[:-1], ci) + n[-1]
                                   for n in nodes]
                        p.write(",".join(renamed) + "\n")
            cno_off += max_cno

    for out, attr in ((fwd_path, "fwd_path"), (rve_path, "rve_path")):
        with open(out, "wb") as o:
            for ds in sub:
                with open(getattr(ds, attr), "rb") as f:
                    o.write(f.read())

    return SynthDataset(gfa_path, paths_path, fwd_path, rve_path,
                        all_haps, all_names, sub[0].k)
