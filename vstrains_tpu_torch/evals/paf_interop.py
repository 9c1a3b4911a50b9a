"""External-aligner interoperability for PE-link inference (component C12).

The reference's legacy v1.0 pipeline chopped reads into (k+1)-mer
sub-reads, aligned them with minimap2, and rebuilt the link matrices from
the PAF perfect matches (/root/reference/utils/VStrains_Alignment.py).
The hash engine (ops/pe_infer) superseded it — the reference itself
retired the minimap2 path (reference README.md:41-44) — but the *contract*
remains useful for cross-validating against any external exact aligner:

  * `export_subread_fastq` writes the per-window sub-read FASTQ batches
    the aligner consumes (parity: VStrains_Alignment.py:160-289);
  * `pe_matrices_from_paf` rebuilds node_mat/short_mat from perfect-match
    PAF records with the reference's exact saturation rules (parity:
    VStrains_Alignment.py:10-157).

`pe_matrices_from_paf` is equivalence-tested against the device engine on
synthetic alignments.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

_LOG = logging.getLogger(__name__)


def export_subread_fastq(reads: Sequence[Tuple[str, str]], out_fwd: str,
                         out_rve: str, split_len: int) -> List[tuple]:
    """Write every (k+1)-mer sub-read of each read pair as its own FASTQ
    record named `<pair_idx>_<window_idx> /1|2`. Returns read_ids records
    (pair_idx, n_fwd_windows, n_rve_windows, fwd_len, rve_len)."""
    read_ids = []
    with open(out_fwd, "w") as ff, open(out_rve, "w") as fr:
        for j, (fseq, rseq) in enumerate(reads):
            nf = len(fseq) - split_len + 1
            nr = len(rseq) - split_len + 1
            for sub_i in range(nf):
                ff.write(f"@{j}_{sub_i} /1\n{fseq[sub_i:sub_i+split_len]}"
                         f"\n+\n{'I'*split_len}\n")
            for sub_i in range(nr):
                fr.write(f"@{j}_{sub_i} /2\n{rseq[sub_i:sub_i+split_len]}"
                         f"\n+\n{'I'*split_len}\n")
            read_ids.append((j, nf, nr, len(fseq), len(rseq)))
    return read_ids


def pe_matrices_from_paf(ids: Sequence[str], seq_lens: Sequence[int],
                         read_ids: Sequence[tuple], fwd_paf: str,
                         rve_paf: str, split_len: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Rebuild (node_mat, short_mat) from sub-read PAF alignments.

    Perfect-match filter: residue matches == block length == split_len
    (VStrains_Alignment.py:68-69); per-(read, node) stats and saturation
    identical to the hash engine.
    """
    n = len(ids)
    id2index = {vid: i for i, vid in enumerate(ids)}
    node_mat = np.zeros((n, n), dtype=np.int64)
    short_mat = np.zeros((n, n), dtype=np.int64)

    # per read end: {pair_idx: list per window of [(node_idx, ref_coord)]}
    hits_f: Dict[int, list] = {}
    hits_r: Dict[int, list] = {}
    for (j, nf, nr, _fl, _rl) in read_ids:
        hits_f[j] = [[] for _ in range(nf)]
        hits_r[j] = [[] for _ in range(nr)]

    for path, hits in ((fwd_paf, hits_f), (rve_paf, hits_r)):
        with open(path) as fh:
            for line in fh:
                if line == "\n":
                    break
                sp = line.rstrip("\n").split("\t")
                if len(sp) < 11:
                    continue
                glb, sub = sp[0].split("_")
                ref_no = str(sp[5])
                ref_start = int(sp[7])
                nmatch = int(sp[9])
                nblock = int(sp[10])
                if nblock - nmatch == 0 and nblock == split_len:
                    if ref_no in id2index and int(glb) in hits:
                        hits[int(glb)][int(sub)].append(
                            (id2index[ref_no], ref_start))

    def saturated(windows, rlen):
        counts = np.zeros(n, dtype=int)
        coords = [sys.maxsize] * n
        kindices = [sys.maxsize] * n
        for i, window_hits in enumerate(windows):
            for (node, coord) in window_hits:
                counts[node] += 1
                coords[node] = min(coords[node], coord)
                kindices[node] = min(kindices[node], i)
        out = []
        for i, v in enumerate(counts):
            if coords[i] == sys.maxsize:
                continue
            L = max(coords[i], coords[i] - kindices[i])
            R = min(coords[i] + seq_lens[i] - 1,
                    coords[i] - kindices[i] + rlen - 1)
            saturate = R - L - (split_len - 1) + 1
            expected = ((min(rlen, seq_lens[i]) - split_len + 1)
                        * (rlen - split_len) / rlen)
            if v >= max(min(saturate, expected), 1):
                out.append(i)
        return out

    for (j, _nf, _nr, flen, rlen) in read_ids:
        lefts = saturated(hits_f[j], flen)
        rights = saturated(hits_r[j], rlen)
        k = 0
        for i in lefts:
            for i2 in lefts[k:]:
                short_mat[i][i2] += 1
            k += 1
        k = 0
        for a in rights:
            for b in rights[k:]:
                short_mat[a][b] += 1
            k += 1
        for i in lefts:
            for b in rights:
                node_mat[i][b] += 1
    return node_mat, short_mat


def aligner_available(exe: str = "minimap2") -> bool:
    import shutil
    return shutil.which(exe) is not None


def run_legacy_alignment(ids: Sequence[str], seqs: Sequence[str],
                         reads: Sequence[Tuple[str, str]], kmer_size: int,
                         work_dir: str, threads: int = 16,
                         logger: logging.Logger = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Drive the legacy aligner path end-to-end with a REAL minimap2.

    Writes the node reference FASTA, exports every (k+1)-mer sub-read,
    invokes `minimap2 -c -t N` per end (the reference's invocation,
    VStrains_Alignment.py:292-323), and rebuilds the matrices from the
    PAFs. Requires minimap2 on PATH (aligner_available()); used to
    cross-validate the hash engine against an external exact aligner.
    """
    import os
    import subprocess

    logger = logger or _LOG
    split_len = kmer_size + 1
    os.makedirs(work_dir, exist_ok=True)
    ref_fa = os.path.join(work_dir, "nodes.fa")
    with open(ref_fa, "w") as fh:
        for vid, seq in zip(ids, seqs):
            fh.write(f">{vid}\n{seq}\n")
    sub_f = os.path.join(work_dir, "sub_1.fastq")
    sub_r = os.path.join(work_dir, "sub_2.fastq")
    read_ids = export_subread_fastq(reads, sub_f, sub_r, split_len)
    paf_f = os.path.join(work_dir, "aln_1.paf")
    paf_r = os.path.join(work_dir, "aln_2.paf")
    for sub, paf in ((sub_f, paf_f), (sub_r, paf_r)):
        with open(paf, "w") as out:
            subprocess.run(["minimap2", "-c", "-t", str(threads),
                            ref_fa, sub], stdout=out, check=True)
        logger.debug("aligned %s -> %s", sub, paf)
    return pe_matrices_from_paf(ids, [len(s) for s in seqs], read_ids,
                                paf_f, paf_r, split_len)
