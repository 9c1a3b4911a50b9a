"""Paired-FASTQ random down-sampler.

Parity: /root/reference/evals/sampling.py (1/s uniform pair sampling),
re-implemented with a seeded vectorized mask so runs are reproducible.

    python -m vstrains_tpu_torch.evals.sampling -s 2 -f r1.fq -r r2.fq \
        -of out1.fq -or out2.fq [--seed 0]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def sample_pairs(fwd_path: str, rve_path: str, out_fwd: str, out_rve: str,
                 sratio: int, seed: int = None) -> int:
    if sratio <= 1:
        raise ValueError("sampling ratio must be > 1")
    with open(fwd_path, "rb") as f:
        flines = f.read().split(b"\n")
    with open(rve_path, "rb") as f:
        rlines = f.read().split(b"\n")
    n = min(len(flines) // 4, len(rlines) // 4)
    rng = np.random.RandomState(seed)
    keep = rng.random_sample(n) <= 1.0 / sratio
    k = int(keep.sum())
    with open(out_fwd, "wb") as of, open(out_rve, "wb") as orv:
        for i in np.flatnonzero(keep):
            of.write(b"\n".join(flines[i * 4: i * 4 + 4]) + b"\n")
            orv.write(b"\n".join(rlines[i * 4: i * 4 + 4]) + b"\n")
    print(f"reads in input: {n}")
    print(f"sample {k} reads given ratio {sratio}")
    return k


def quality_trim(fwd_path: str, rve_path: str, out_fwd: str,
                 out_rve: str, min_q: int = 20, window: int = 5,
                 min_len: int = 30) -> int:
    """Quality-driven 3' trimming of a paired FASTQ set (Trimmomatic
    SLIDINGWINDOW-style): cut each read at the first position where the
    mean Phred quality of the following `window` bases drops below
    `min_q`, then drop PAIRS whose either mate falls under `min_len`.

    The reference pipeline performs no trimming (its PE inference simply
    discards N-containing reads); this is an eval-side preprocessor for
    realistic error-model runs — both engines read the SAME trimmed
    files, so every A/B comparison stays on identical inputs. Returns
    the number of surviving pairs."""
    with open(fwd_path, "rb") as f:
        flines = f.read().split(b"\n")
    with open(rve_path, "rb") as f:
        rlines = f.read().split(b"\n")
    n = min(len(flines) // 4, len(rlines) // 4)

    def cutpoint(qual: bytes) -> int:
        q = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - 33
        if q.size < window:
            return q.size if (q.size and q.mean() >= min_q) else 0
        means = np.convolve(q, np.ones(window), "valid") / window
        bad = np.flatnonzero(means < min_q)
        return int(bad[0]) if bad.size else q.size

    kept = 0
    with open(out_fwd, "wb") as of, open(out_rve, "wb") as orv:
        for i in range(n):
            frec = flines[i * 4: i * 4 + 4]
            rrec = rlines[i * 4: i * 4 + 4]
            fcut = cutpoint(frec[3])
            rcut = cutpoint(rrec[3])
            if fcut < min_len or rcut < min_len:
                continue
            of.write(b"\n".join([frec[0], frec[1][:fcut], frec[2],
                                 frec[3][:fcut]]) + b"\n")
            orv.write(b"\n".join([rrec[0], rrec[1][:rcut], rrec[2],
                                  rrec[3][:rcut]]) + b"\n")
            kept += 1
    return kept


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sampling", description="Randomly down-sample a paired FASTQ set")
    parser.add_argument("-s", "--sampling_ratio", dest="sratio", type=int,
                        required=True,
                        help="sampling ratio, 2 for half the dataset")
    parser.add_argument("-f", "--forward", dest="fwd", required=True)
    parser.add_argument("-r", "--reverse", dest="rve", required=True)
    parser.add_argument("-of", "--out_forward", dest="ofwd", required=True)
    parser.add_argument("-or", "--out_reverse", dest="orve", required=True)
    parser.add_argument("--seed", dest="seed", type=int, default=None)
    args = parser.parse_args(argv)
    sample_pairs(args.fwd, args.rve, args.ofwd, args.orve, args.sratio,
                 args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
