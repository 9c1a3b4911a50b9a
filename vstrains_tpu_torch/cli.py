"""Command-line entry point of the PyTorch port (`vstrains-tpu-torch`).

The flags of the JAX package's CLI (itself at flag parity with the
reference executable: -a/-g/-p/-o/-fwd/-rve plus hidden -mc/-ml/-r/-d),
plus `--device {cuda,cpu}` (default cuda; there is no automatic CPU
fallback). Same output-dir scaffolding (gfa/ tmp/ paf/ aln/) and dual
console+file logging.
"""

from __future__ import annotations

import argparse
import logging
import os
import platform
import sys
import time
from datetime import date

from vstrains_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vstrains-tpu-torch",
        description="Construction of full-length viral strains from "
                    "contigs and assembly graph (SPAdes), in PyTorch "
                    "with CUDA kernels")
    parser.add_argument("-a", "--assembler", dest="assembler", type=str,
                        required=True, choices=["spades"],
                        help="assembler that produced the inputs (spades)")
    parser.add_argument("-g", "--graph", dest="gfa_file", type=str,
                        required=True,
                        help="assembly graph in GFA 1.0 format")
    parser.add_argument("-p", "--path", dest="path_file", type=str,
                        required=False,
                        help="SPAdes contigs.paths file")
    parser.add_argument("-mc", "--minimum_coverage", dest="min_cov",
                        default=None, type=int, help=argparse.SUPPRESS)
    parser.add_argument("-ml", "--minimum_contig_length", dest="min_len",
                        default=None, type=int, help=argparse.SUPPRESS)
    parser.add_argument("-r", "--reference_fa", dest="ref_file",
                        default=None, type=str, help=argparse.SUPPRESS)
    parser.add_argument("-o", "--output_dir", dest="output_dir",
                        default="acc/", type=str,
                        help="where results are written [default: acc/]")
    parser.add_argument("-d", "--dev_mode", dest="dev", action="store_true",
                        default=False, help=argparse.SUPPRESS)
    parser.add_argument("-fwd", "--fwd_file", dest="fwd", required=True,
                        type=str,
                        help="forward FASTQ of the read pairs")
    parser.add_argument("-rve", "--rve_file", dest="rve", required=True,
                        type=str,
                        help="reverse FASTQ of the read pairs")
    parser.add_argument("--pe-batch-size", dest="pe_batch_size",
                        default=16384, type=int, help=argparse.SUPPRESS)
    parser.add_argument("--pe-files", dest="pe_files", default="auto",
                        choices=["auto", "full", "sparse", "off"],
                        help="aln/pe_info + aln/st_info format: 'full' = "
                             "the reference's N^2-line files, 'sparse' = "
                             "nonzero u:v:count lines only (loads "
                             "identically), 'auto' = full up to 5,000 "
                             "nodes then sparse [default: auto]")
    parser.add_argument("--resume", dest="resume", action="store_true",
                        default=False,
                        help="resume from the last completed stage "
                             "checkpoint in the output directory")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the PE engine and device passes run; "
                             "'cuda' needs a GPU [default: cuda]")
    parser.add_argument("--per-component", dest="per_component",
                        action="store_true", default=False,
                        help="disentangle/extend weakly-connected graph "
                             "components independently (metaSPAdes "
                             "multi-component graphs)")
    parser.add_argument("--component-workers", dest="component_workers",
                        default=1, type=int,
                        help="worker processes for per-component "
                             "extraction")
    parser.add_argument("--tip-removal", dest="tip_removal",
                        action="store_true", default=False,
                        help="collapse source/sink tips on cyclic graphs "
                             "before PE inference (k-mer containment "
                             "scoring)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if (not args.gfa_file) or (not os.path.exists(args.gfa_file)):
        print("\nAssembly graph (.gfa) not found - check the -g path.")
        print("\nExiting...\n")
        return 1
    args.assembler = args.assembler.lower()
    if args.assembler == "spades":
        if (not args.path_file) or (not os.path.exists(args.path_file)):
            print("\nThe spades assembler option needs a contigs.paths "
                  "file (-p).")
            print("\nExiting...\n")
            return 1
    else:
        print("\nUnsupported assembler; only spades is available.")
        return 1

    if args.min_len is not None:
        if args.min_len < 0:
            print("\ninvalid value for min_len")
            return 1
    else:
        args.min_len = 250
    if args.min_cov is not None and args.min_cov < 0:
        print("\ninvalid value for min_cov")
        return 1

    if args.output_dir.endswith("/"):
        args.output_dir = args.output_dir[:-1]
    os.makedirs(args.output_dir, exist_ok=True)
    if args.resume:
        for sub in ["gfa", "tmp", "paf", "aln"]:
            os.makedirs(f"{args.output_dir}/{sub}", exist_ok=True)
    else:
        try:
            os.makedirs(args.output_dir + "/gfa/")
            os.makedirs(args.output_dir + "/tmp/")
            os.makedirs(args.output_dir + "/paf/")
            os.makedirs(args.output_dir + "/aln/")
        except OSError:
            print("\nRefusing to write into a non-empty output directory.")
            print("Clear or change it first: " + str(args.output_dir))
            print("\nExiting...\n")
            return 1

    logger = logging.getLogger("vstrains-tpu-torch %s" % __version__)
    logger.setLevel(logging.DEBUG if args.dev else logging.INFO)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)
    fileh = logging.FileHandler(args.output_dir + "/vstrains.log")
    fileh.setLevel(logging.DEBUG if args.dev else logging.INFO)
    fileh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(fileh)

    logger.info("Welcome to vstrains-tpu-torch!")
    logger.info("Environment:")
    try:
        logger.info("  version: " + str(__version__))
        logger.info("  python: "
                    + ".".join(map(str, sys.version_info[0:3])))
        logger.info("  OS: " + platform.platform())
    except Exception:
        logger.info("  (environment probe failed)")
    start_time = time.time()
    logger.info("Inputs:")
    logger.info("  assembler: " + args.assembler)
    logger.info("  graph: " + args.gfa_file)
    logger.info("  forward reads: " + args.fwd)
    logger.info("  reverse reads: " + args.rve)
    logger.info("  contig paths: " + str(args.path_file))
    logger.info("  device: " + args.device)
    logger.info("  output dir: " + os.path.abspath(args.output_dir))

    fmt = logging.Formatter("%(asctime)s %(levelname)s | %(message)s")
    console.setFormatter(fmt)
    fileh.setFormatter(fmt)

    if args.dev:
        # fail-fast numeric guards (reference parity: numpy.seterr at
        # vstrains:25)
        from vstrains_tpu_torch.utils.validate import enable_numeric_guards
        enable_numeric_guards()

    from vstrains_tpu_torch import pipeline
    from vstrains_tpu_torch.core.contig_io import PathsFormatError
    from vstrains_tpu_torch.core.gfa import GfaFormatError
    try:
        pipeline.run(args, logger)
    except (pipeline.PipelineError, GfaFormatError,
            PathsFormatError) as err:
        logger.error(str(err))
        logger.error("Run aborted before results were produced")
        logger.removeHandler(fileh)
        logger.removeHandler(console)
        return 1

    elapsed = time.time() - start_time
    console.setFormatter(logging.Formatter("%(message)s"))
    fileh.setFormatter(logging.Formatter("%(message)s"))
    logger.info("")
    logger.info("Final strains: {0}/strain.fasta".format(
        os.path.abspath(args.output_dir)))
    logger.info("Finished: {0}".format(date.today().strftime("%B %d, %Y")))
    logger.info("Wall time: {0:.2f}s".format(elapsed))
    logger.removeHandler(fileh)
    logger.removeHandler(console)
    return 0


if __name__ == "__main__":
    sys.exit(main())
