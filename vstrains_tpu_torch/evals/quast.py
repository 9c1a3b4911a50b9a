"""MetaQUAST evaluation wrapper.

Parity: /root/reference/evals/quast_evaluation.py — splits a multi-strain
reference FASTA into per-strain files and runs MetaQUAST with the
reference's settings (`--unique-mapping --report-all-metrics -m 500 -t 8`).
QUAST is an external tool (not bundled); the wrapper degrades to a clear
error when it is absent.

    python -m vstrains_tpu_torch.evals.quast -quast PATH -cs a.fasta b.fasta \
        -ref refs.fasta -o out/
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List


def sep_ref(ref_file: str, out_dir: str = ".", run_id: int = 0
            ) -> List[str]:
    """Split a multi-FASTA of strain references into one file per strain
    (parity: quast_evaluation.py:11-36)."""
    ref_file_list = []
    with open(ref_file, "r") as ref:
        lines = ref.readlines()
    j = 0
    while j < len(lines) - 1:
        name_in_file = lines[j]
        name = str(lines[j][1:-1]).split(" ")[0].split(".")[0]
        strain = lines[j + 1]
        j += 2
        file_name = os.path.join(out_dir,
                                 f"sub_{run_id}_{name}_ref.fasta")
        with open(file_name, "w") as sub_file:
            sub_file.write(name_in_file)
            sub_file.write(strain)
        ref_file_list.append(file_name)
    print("ref list: ", ref_file_list)
    return ref_file_list


def quast_eval(files: List[str], ref: str, out_dir: str, quast_path: str,
               run_id: int = 0, threads: int = 8) -> None:
    """Run MetaQUAST over candidate contig sets
    (parity: quast_evaluation.py:38-60)."""
    ref_file_list = sep_ref(ref, ".", run_id)
    runner = [sys.executable, quast_path] if quast_path.endswith(".py") \
        else [quast_path]
    cmd = [*runner, "--unique-mapping", "--report-all-metrics",
           "-m", "500", "-t", str(threads), *files, "-o", out_dir,
           "-R", ",".join(ref_file_list)]
    print(" ".join(cmd))
    try:
        subprocess.check_call(cmd)
    finally:
        for f in ref_file_list:
            try:
                os.remove(f)
            except OSError:
                pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="quast", description="Use MetaQUAST to evaluate assembly "
                                  "result")
    parser.add_argument("-quast", "--path_to_quast", dest="quast",
                        required=True,
                        help="path to MetaQuast python script, >= 5.2.0")
    parser.add_argument("-cs", "--contig_files", dest="files", default=None,
                        nargs="+", help="contig files, space separated")
    parser.add_argument("-d", "--contig_dir", dest="idir", default=None,
                        help="directory of .fasta contig files")
    parser.add_argument("-ref", "--ref_file", dest="ref_file", type=str,
                        required=True, help="single-strain reference FASTA")
    parser.add_argument("-o", "--output_dir", dest="output_dir", type=str,
                        required=True)
    args = parser.parse_args(argv)

    if args.idir is None and args.files is None:
        print("No usable query FASTA given; nothing to evaluate.")
        return 1
    if args.idir is not None and not os.path.isdir(args.idir):
        print("Output directory argument is missing or invalid.")
        return 1
    files = list(args.files or [])
    if args.idir is not None:
        files.extend(os.path.join(args.idir, s)
                     for s in sorted(os.listdir(args.idir))
                     if s.endswith((".fasta", ".fa")))
    quast_eval(files, args.ref_file, args.output_dir, args.quast)
    return 0


if __name__ == "__main__":
    sys.exit(main())
