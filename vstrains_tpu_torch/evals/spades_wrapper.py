"""SPAdes invocation wrapper (component C30).

Parity with /root/reference/utils/spades_wrapper.py — runs `spades
--careful` on a read pair to produce the assembly graph + contigs this
framework consumes — with the reference's argument-count bug fixed
(reference spades_wrapper.py:60-66 formats 5 placeholders with 4 args).

    python -m vstrains_tpu_torch.evals.spades_wrapper -f R1 -r R2 \
        -spades /path/to/spades.py -o asm/
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time


def run_spades(fwd: str, rve: str, spades_path: str, out_dir: str,
               threads: int = 8) -> int:
    t1 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [spades_path, "-1", fwd, "-2", rve, "--careful",
           "-t", str(threads), "-o", out_dir]
    print(" ".join(cmd))
    rc = subprocess.call(cmd)
    print("SPAdes assembly completed")
    print(f"Elapsed time: {time.perf_counter() - t1:.1f} seconds")
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="spades_wrapper",
        description="Build assembly graph & contigs using SPAdes "
                    "--careful mode from paired-end reads.")
    parser.add_argument("-f", "--forward", dest="forward", required=True)
    parser.add_argument("-r", "--reverse", dest="reverse", required=True)
    parser.add_argument("-spades", "--spades_path", dest="spades",
                        required=True,
                        help="path to the spades executable")
    parser.add_argument("-t", "--threads", dest="threads", default=8,
                        type=int)
    parser.add_argument("-o", "--output_dir", dest="output_dir",
                        required=True)
    args = parser.parse_args(argv)
    if not args.spades:
        print("No SPAdes executable given (use -spades/--path_to_spades).")
        return 1
    return run_spades(args.forward, args.reverse, args.spades,
                      args.output_dir, args.threads)


if __name__ == "__main__":
    sys.exit(main())
