"""Standalone PE-link inference CLI of the PyTorch port.

Drop-in interface parity with the reference's child process
(VStrains_PE_Inference.py:51-216) and the JAX package's `pe_cli`:

    python -m vstrains_tpu_torch.pe_cli -g GFA -o DIR -f FWD -r RVE -k K \
        [--device cuda|cpu]

reads the canonized GFA's S-lines in file order, runs the device engine,
and writes `DIR/pe_info` + `DIR/st_info` in the same N^2-line
`u:v:count` format. On a CUDA device the kernel library builds on a
background thread while the FASTQs load (`ops._build.Prefetch`, as in
the pipeline); a failed build raises with nvcc's output.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def main(argv=None) -> int:
    print("== PE link inference (PyTorch engine) ==")
    parser = argparse.ArgumentParser(
        prog="pe_info",
        description="Match read pairs against graph-node k-mers and "
                    "emit the PE/single-strand link count files")
    parser.add_argument("-g", "--gfa", dest="gfa", type=str, required=True,
                        help="assembly graph (GFA 1.0)")
    parser.add_argument("-o", "--output_dir", dest="dir", type=str,
                        required=True, help="directory for pe_info/st_info")
    parser.add_argument("-f", "--forward", dest="fwd", required=True,
                        help="forward FASTQ")
    parser.add_argument("-r", "--reverse", dest="rve", required=True,
                        help="reverse FASTQ")
    parser.add_argument("-k", "--kmer_size", dest="kmer_size", type=int,
                        default=128, help="graph k; windows are (k+1)-mers")
    parser.add_argument("--batch-size", dest="batch_size", type=int,
                        default=8192)
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the engine runs [default: cuda]")
    args = parser.parse_args(argv)

    from vstrains_tpu_torch.device import resolve_device
    from vstrains_tpu_torch.ops import _build
    device = resolve_device(args.device)

    out_dir = args.dir.rstrip("/")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)

    glb_start = time.time()

    # S-lines in file order (reference: PE_Inference.py:105-112)
    index2id = []
    index2seq = []
    with open(args.gfa, "r") as gfa:
        for line in gfa:
            fields = line.rstrip("\n").split("\t")
            if fields and fields[0] == "S":
                index2id.append(fields[1])
                index2seq.append(fields[2])

    from vstrains_tpu_torch.core.fastq import load_read_pairs
    from vstrains_tpu_torch.ops.pe_infer import infer_pe_links, write_pe_files

    split_len = args.kmer_size + 1
    with _build.Prefetch(device) as kernels:
        print("matching read pairs against node k-mers")
        reads = load_read_pairs(args.fwd, args.rve, split_len,
                                pad_to_multiple=32)
        print(f"reads: used={reads.used_reads}, with_N={reads.n_reads}, "
              f"short={reads.short_reads}")
        kernels.join()
    result = infer_pe_links(index2id, index2seq, reads, args.kmer_size,
                            batch_size=args.batch_size, device=device)
    build_line = kernels.report()
    if build_line is not None:
        print(build_line)
    write_pe_files(result, f"{out_dir}/pe_info", f"{out_dir}/st_info")

    print(f"wall time: {time.time() - glb_start:.2f}s")
    print(f"wrote {out_dir}/pe_info and {out_dir}/st_info")
    return 0


if __name__ == "__main__":
    sys.exit(main())
