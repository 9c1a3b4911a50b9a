"""In-repo NGA50 / genome-fraction scorer.

The reference's published evaluation metric is MetaQUAST's NGA50
(/root/reference/evals/quast_evaluation.py:38-60: per-strain reference
split + `metaquast --unique-mapping ... -m 500`), but no QUAST binary
exists in this environment, so BASELINE.md's "NGA50 parity" row never
held a number. This module computes the same quantity self-contained:

  NGA50 of a reference R = the largest L such that the ALIGNED blocks
  (contig pieces aligned to R, broken at misassembly boundaries) of
  length >= L together cover >= 50% of |R|. 0 when total aligned
  coverage is under 50% (QUAST reports "-").

Alignment here is exact-k-mer anchor chaining (the same primitive the
engine's PE inference and tip scoring are built on): anchors grouped by
diagonal give maximal exact blocks; blocks on the same diagonal merge
across small substitution gaps (<= 5% of the merged span, QUAST's 95%
local-identity spirit); nearby diagonals (|shift| <= 20) merge across
small indels, counting only the exactly-aligned bases. A contig is
assigned to the reference with the largest total aligned length
(QUAST --unique-mapping), both strands tried.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vstrains_tpu_torch.core.seq import revcomp_str


def _exact_blocks(contig: str, ref: str, k: int
                  ) -> List[Tuple[int, int, int]]:
    """Maximal exact-match blocks as (ref_start, ref_end, exact_bases)
    half-open; exact_bases counts only anchor-covered positions, NOT
    the substitution/indel gap interiors the merge spans — reference
    assignment must rank by true sequence agreement, or two
    near-identical references (the SARS-CoV-2 wastewater regime, 99.7%
    identity) both capture every contig via gap-padded spans."""
    if len(contig) < k or len(ref) < k:
        return []
    index: Dict[str, List[int]] = {}
    for i in range(len(ref) - k + 1):
        index.setdefault(ref[i: i + k], []).append(i)
    # anchors per diagonal d = cpos - rpos; within a diagonal anchors at
    # consecutive rpos form one exact run
    diags: Dict[int, List[int]] = {}
    for c in range(len(contig) - k + 1):
        for r in index.get(contig[c: c + k], ()):
            diags.setdefault(c - r, []).append(r)
    blocks: List[Tuple[int, int, int]] = []   # (diag, start, end)
    for d, rs in diags.items():
        rs.sort()
        start = prev = rs[0]
        for r in rs[1:]:
            if r == prev + 1:
                prev = r
                continue
            blocks.append((d, start, prev + k))
            start = prev = r
        blocks.append((d, start, prev + k))
    if not blocks:
        return []
    # merge same-diagonal blocks across small substitution gaps; the
    # span extends over the gap but exact_bases sums only the parts
    blocks.sort()
    merged: List[Tuple[int, int, int, int]] = []  # (d, s, e, exact)
    for d, s, e in blocks:
        if merged and merged[-1][0] == d:
            pd, ps, pe, px = merged[-1]
            gap = s - pe
            span = e - ps
            if 0 <= gap <= max(8, int(0.05 * span)):
                merged[-1] = (d, ps, e, px + (e - s))
                continue
        merged.append((d, s, e, e - s))
    # chain near-diagonal blocks across small indels: the merged span
    # counts as one alignment (QUAST alignments likewise include
    # bounded mismatch/indel interior)
    merged.sort(key=lambda b: (b[1], b[2]))
    out: List[Tuple[int, int, int]] = []
    used = [False] * len(merged)
    for i, (d, s, e, x) in enumerate(merged):
        if used[i]:
            continue
        cs, ce, cd, cx = s, e, d, x
        for j in range(i + 1, len(merged)):
            if used[j]:
                continue
            dj, sj, ej, xj = merged[j]
            if sj - ce > 30:
                break
            if abs(dj - cd) <= 20 and -k < sj - ce <= 30:
                ce, cd, cx = max(ce, ej), dj, cx + xj
                used[j] = True
        out.append((cs, ce, cx))
    return out


def _aligned(contig: str, ref: str, k: int) -> List[Tuple[int, int, int]]:
    fwd = _exact_blocks(contig, ref, k)
    rev = _exact_blocks(revcomp_str(contig), ref, k)
    return fwd if (sum(x for _, _, x in fwd)
                   >= sum(x for _, _, x in rev)) else rev


def _union_len(blocks: Sequence[Tuple[int, int]]) -> int:
    if not blocks:
        return 0
    bs = sorted(blocks)
    total, cs, ce = 0, bs[0][0], bs[0][1]
    for s, e in bs[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return total + (ce - cs)


def nga50_report(contigs: Dict[str, str], refs: Dict[str, str],
                 k: int = 31, min_block: int = 500) -> Dict[str, dict]:
    """Per-reference NGA50 / genome fraction / largest alignment.

    min_block mirrors MetaQUAST's `-m 500` minimum contig/alignment
    size (quast_evaluation.py:46)."""
    per_ref_blocks: Dict[str, List[Tuple[int, int]]] = {r: []
                                                        for r in refs}
    for cname, cseq in contigs.items():
        if len(cseq) < min_block:
            continue
        # assignment ranks by EXACT-anchored bases (true agreement),
        # so between near-identical references the real origin wins;
        # gap-padded spans only feed the coverage/NGA50 block lengths
        best, best_blocks, best_total = None, [], 0
        for rname, rseq in refs.items():
            blocks = _aligned(cseq, rseq, k)
            total = sum(x for _, _, x in blocks)
            if total > best_total:
                best, best_blocks, best_total = rname, blocks, total
        if best is not None:
            per_ref_blocks[best].extend(
                (s, e) for s, e, _ in best_blocks
                if e - s >= min_block)
    report = {}
    for rname, rseq in refs.items():
        blocks = per_ref_blocks[rname]
        lens = sorted((e - s for s, e in blocks), reverse=True)
        half = 0.5 * len(rseq)
        acc, nga = 0, 0
        for ln in lens:
            acc += ln
            if acc >= half:
                nga = ln
                break
        report[rname] = {
            "nga50": int(nga),
            "genome_fraction": round(
                100.0 * _union_len(blocks) / len(rseq), 3),
            "largest_alignment": int(lens[0]) if lens else 0,
            "total_aligned": int(sum(lens)),
            "ref_len": len(rseq),
        }
    vals = [r["nga50"] for r in report.values()]
    report["_aggregate"] = {
        "mean_nga50": float(np.mean(vals)) if vals else 0.0,
        "min_nga50": int(min(vals)) if vals else 0,
        "refs_with_nga50": int(sum(1 for v in vals if v > 0)),
        "num_refs": len(vals),
    }
    return report


def load_fasta(path: str) -> Dict[str, str]:
    recs: Dict[str, str] = {}
    name, parts = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    recs[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            elif line:
                parts.append(line)
    if name is not None:
        recs[name] = "".join(parts)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nga50", description="Self-contained NGA50 scorer "
        "(QUAST-style, exact-anchor alignment)")
    ap.add_argument("-c", "--contigs", required=True,
                    help="assembled strains FASTA (strain.fasta)")
    ap.add_argument("-r", "--refs", required=True,
                    help="per-strain reference FASTA")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-m", "--min-block", type=int, default=500)
    args = ap.parse_args(argv)
    rep = nga50_report(load_fasta(args.contigs), load_fasta(args.refs),
                       k=args.k, min_block=args.min_block)
    agg = rep.pop("_aggregate")
    for rname in sorted(rep):
        r = rep[rname]
        print(f"{rname}\tNGA50={r['nga50']}\tGF={r['genome_fraction']}%"
              f"\tlargest={r['largest_alignment']}\tlen={r['ref_len']}")
    print(f"mean_NGA50={agg['mean_nga50']:.1f}\t"
          f"min_NGA50={agg['min_nga50']}\t"
          f"refs_covered={agg['refs_with_nga50']}/{agg['num_refs']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
