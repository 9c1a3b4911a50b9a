"""Closed loop over passes of the PE engine alone, on reads loaded once.

A step is what the pipeline's PE stage does after its FASTQ load: the
k-mer table built anew (`build_kmer_table`), so that no cache keyed on
a table object can stand in for the work, then `infer_pe_links` over
every read pair at the traffic's batch size. The nodes are the
dataset's graph segments; the reads are loaded once by the program's
loader.
"""

from __future__ import annotations

import logging
import os
import time

from torch.profiler import record_function

from portbench import check, data
from portbench.reference import pe_links


class _Lines(logging.Handler):
    def __init__(self, log):
        super().__init__(logging.INFO)
        self.log = log

    def emit(self, record):
        self.log("engine: " + record.getMessage())


class Loop:
    LIMITS = {"pe_links_differ": 0}

    def __init__(self, ctx):
        from vstrains_tpu_torch.core.fastq import load_read_pairs
        from vstrains_tpu_torch.ops import pe_infer

        self.ctx = ctx
        self.pe = pe_infer
        self.ids, self.seqs, self.k = data.read_gfa(ctx.paths["gfa"])
        t0 = time.perf_counter()
        rp = self.reads = load_read_pairs(ctx.paths["fwd"], ctx.paths["rve"],
                                          self.k + 1, pad_to_multiple=32)
        ctx.log(f"reads: {rp.num_pairs} pairs used, {rp.n_reads} with N, "
                f"{rp.short_reads} short, loaded in "
                f"{time.perf_counter() - t0:.2f} s; {len(self.ids)} nodes, "
                f"k = {self.k}")
        self.batch = ctx.traffic["pe_batch_size"]
        self.logger = logging.getLogger("portbench.engine")
        self.logger.propagate = False
        self.logger.setLevel(logging.INFO)
        self.lines = _Lines(ctx.log)

    def warm_up(self) -> None:
        """One pass, which builds or loads the kernel library; the log
        names the engine's route."""
        from vstrains_tpu_torch.ops import _build

        self.logger.addHandler(self.lines)
        self.step()
        self.logger.removeHandler(self.lines)
        route = ("sparse" if self.batch > self.pe.dense_budget_rows(
            len(self.ids)) else "dense")
        info = _build.loaded_info()
        self.ctx.log(f"route: {route} engine at N = {len(self.ids)}, batch "
                     f"{self.batch}; "
                     + (f"library {os.path.basename(info['path'])}, built "
                        f"{info['built']} ({info['seconds']:.1f} s)"
                        if info else "no kernel library (CPU)"))

    def step(self, win=None) -> dict:
        t0 = time.perf_counter()
        with record_function("portbench.build_kmer_table"):
            table = self.pe.build_kmer_table(self.seqs, self.k + 1)
        with record_function("portbench.infer_pe_links"):
            res = self.pe.infer_pe_links(self.ids, self.seqs, self.reads,
                                         self.k, batch_size=self.batch,
                                         table=table, logger=self.logger,
                                         device=self.ctx.device)
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "pairs": self.reads.num_pairs,
                "result": res, "failed": False}

    def dispose(self, rec: dict) -> None:
        rec["result"] = None

    def release(self) -> None:
        self.reads = None

    def check(self, kept) -> dict:
        """Every kept pass against one reference run on the same reads."""
        ctx = self.ctx
        ref_reads = pe_links.load_reads(ctx.paths["fwd"], ctx.paths["rve"],
                                        self.k + 1)
        links = pe_links.pe_links(self.seqs, ref_reads, self.k, ctx.device)
        ctx.work.update(links.work)
        worst = 0
        for rec in kept:
            res = rec["result"]
            worst = max(worst, check.links_differ(
                res.node_mat, res.short_mat, links.node_mat, links.short_mat))
        return {"pe_links_differ": worst}
