"""Closed loop with one client: whole samples through the program's CLI,
one after the other, as a lab runs its queue.

A step is `vstrains_tpu_torch.cli.main` in-process, into a fresh output
directory, every stage run (nothing resumed), on the seed's dataset.
The warm-up is one whole sample on the same dataset, deleted after it.
The timed samples that are checked (the last, and one drawn from the
seed) are kept; the others are deleted in the step that follows them.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time

from portbench import check, data
from portbench.reference import pe_links, pipeline

_ENGINE = re.compile(r"PE engine: (\d+) pairs in ([0-9.]+) s")
_TIMING = re.compile(r"\[timing\] (\S+): ([0-9.]+)s")
_TABLE = re.compile(r"kmer table: \d+ entries, max_dup=\d+, (\d+) nodes")
# lines of the PE stage that name its inputs and route, logged after the
# warm-up
_ROUTE = ("reads:", "kmer table:", "sparse PE stats path", "PE engine:")


class _Marks(logging.Handler):
    """The CLI's log lines that the metrics read: the engine's seconds
    and each stage's end, on the host clock."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(("[timing]",) + _ROUTE):
            self.lines.append((record.created, msg))


class Loop:
    LIMITS = {"pe_links_differ": 0, "files_differ": 0}

    def __init__(self, ctx):
        from vstrains_tpu_torch import __version__, cli

        self.ctx = ctx
        self.cli = cli
        self.paths = ctx.paths
        self.batch = str(ctx.traffic["pe_batch_size"])
        self.marks = _Marks()
        logging.getLogger(f"vstrains-tpu-torch {__version__}").addHandler(
            self.marks)
        self.count = 0

    def warm_up(self) -> None:
        """One whole sample, which builds or loads the kernel library and
        the native FASTQ reader; the log names the engine's route."""
        from vstrains_tpu_torch.ops import pe_infer

        rec = self.step()
        self.dispose(rec)
        self.count = 0
        if rec["failed"]:
            raise RuntimeError("the warm-up sample failed")
        lines = [m for _, m in self.marks.lines if m.startswith(_ROUTE)]
        for msg in list(lines):
            m = _TABLE.match(msg)
            if m:
                n = int(m.group(1))
                lines.append("route: " + ("sparse" if int(self.batch) >
                                          pe_infer.dense_budget_rows(n)
                                          else "dense")
                             + f" engine at N = {n}, batch {self.batch}")
        self.ctx.log(f"warm-up sample: {rec['seconds']:.3f} s; "
                     + "; ".join(lines))

    def step(self, win=None) -> dict:
        out = os.path.join(self.ctx.tmp, f"sample{self.count}")
        shutil.rmtree(out, ignore_errors=True)
        self.count += 1
        self.marks.lines.clear()
        p = self.paths
        t0 = time.perf_counter()
        rc = self.cli.main(["-a", "spades", "-g", p["gfa"], "-p", p["paths"],
                            "-fwd", p["fwd"], "-rve", p["rve"], "-o", out,
                            "--pe-batch-size", self.batch, "--device",
                            self.ctx.device.type])
        seconds = time.perf_counter() - t0
        rec = {"seconds": seconds, "samples": 1, "out": out,
               "failed": rc != 0, "stages": {}, "engine_s": None}
        tpath = os.path.join(out, "timings.json")
        if os.path.exists(tpath):
            with open(tpath) as fh:
                rec["stages"] = {s["stage"]: s["seconds"]
                                 for s in json.load(fh)["stages"]}
        for created, msg in self.marks.lines:
            m = _ENGINE.match(msg)
            if m:
                rec["engine_s"] = float(m.group(2))
            m = _TIMING.match(msg)
            if m and win is not None:
                win.marks.append((created - float(m.group(2)), created,
                                  m.group(1)))
        return rec

    def dispose(self, rec: dict) -> None:
        shutil.rmtree(rec["out"], ignore_errors=True)

    def release(self) -> None:
        """Nothing of the program outlives a step."""

    def check(self, kept) -> dict:
        """Every kept sample against one reference run; byte-equal
        outputs are compared once."""
        ctx = self.ctx
        ref_out = os.path.join(ctx.tmp, "reference")
        shutil.rmtree(ref_out, ignore_errors=True)
        _, _, k = data.read_gfa(self.paths["gfa"])
        t0 = time.perf_counter()
        reads = pe_links.load_reads(self.paths["fwd"], self.paths["rve"],
                                    k + 1)
        ids, links = pipeline.run_sample(self.paths["gfa"],
                                         self.paths["paths"], reads, ref_out,
                                         ctx.device)
        ctx.log(f"reference sample: {time.perf_counter() - t0:.1f} s")
        ctx.work.update(links.work)
        worst = {"pe_links_differ": 0, "files_differ": 0}
        done = {}
        for rec in kept:
            key = check.digest(rec["out"])
            if key not in done:
                done[key] = check.sample_checks(rec["out"], ref_out, ids,
                                                links)
            for name, val in done[key].items():
                worst[name] = max(worst[name], val)
        return worst
