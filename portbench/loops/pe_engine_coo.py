"""The PE engine's closed loop (`loops/pe_engine.py`) on either of the
engine's routes: a step is `build_kmer_table`, then `infer_pe_links` at
the traffic's batch size, whose result is the dense engine's `PEResult`
or the sparse engine's COO `PESparseResult`, as the engine's memory rule
picks. The warm-up's log names the route the result took and any batch
clamp the engine made.

The check holds every kept pass to one reference run on the same reads:
a dense result as it is, a COO result scattered into the two [N, N]
int64 matrices on the run's device (a key outside them, or given twice,
counts as a differing entry). It adds to the run's `work` what the
sparse engine's roofline reads, from the reference's matrices:
`sat_entries` (the saturated (read, node) entries: the trace of the
same-end matrix, each read's pair of a node with itself), `pair_links`
and `short_links` (the two matrices' sums).
"""

from __future__ import annotations

import logging
import os

import torch

from portbench import check
from portbench.loops import pe_engine
from portbench.reference import pe_links


class _Said(logging.Handler):
    """The engine's log messages, kept."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def matrices(res, num_nodes: int, device):
    """(node_mat, short_mat, bad) of a dense or COO result: bad counts the
    COO keys outside [0, N²) and the repeats of a key."""
    if hasattr(res, "node_mat"):
        return res.node_mat, res.short_mat, 0
    n2 = num_nodes * num_nodes
    out, bad = [], 0
    for keys, counts in ((res.pair_keys, res.pair_counts),
                         (res.short_keys, res.short_counts)):
        k = torch.as_tensor(keys, device=device).to(torch.int64)
        c = torch.as_tensor(counts, device=device).to(torch.int64)
        ok = (k >= 0) & (k < n2)
        k, c = k[ok], c[ok]
        bad += int((~ok).sum()) + int(k.numel() - torch.unique(k).numel())
        flat = torch.zeros(n2, dtype=torch.int64, device=device)
        flat[k] = c
        out.append(flat.reshape(num_nodes, num_nodes))
    return out[0], out[1], bad


class Loop(pe_engine.Loop):
    LIMITS = {"pe_links_differ": 0}

    def warm_up(self) -> None:
        """One pass, which builds or loads the kernel library; the log
        names the route of its result and the engine's batch clamps."""
        from vstrains_tpu_torch.ops import _build

        said = _Said()
        for h in (self.lines, said):
            self.logger.addHandler(h)
        try:
            res = self.step()["result"]
        finally:
            for h in (self.lines, said):
                self.logger.removeHandler(h)
        route = "dense" if hasattr(res, "node_mat") else "sparse"
        clamps = [m for m in said.messages if "clamped" in m]
        info = _build.loaded_info()
        self.ctx.log(f"route: {route} engine ({type(res).__name__}) at N = "
                     f"{len(self.ids)}, batch {self.batch}, dense up to "
                     f"{self.pe.dense_budget_rows(len(self.ids))}; batch "
                     f"clamp: {'; '.join(clamps) or 'none'}; "
                     + (f"library {os.path.basename(info['path'])}, built "
                        f"{info['built']} ({info['seconds']:.1f} s)"
                        if info else "no kernel library (CPU)"))

    def check(self, kept) -> dict:
        """Every kept pass, dense or COO, against one reference run on the
        same reads."""
        ctx = self.ctx
        ref_reads = pe_links.load_reads(ctx.paths["fwd"], ctx.paths["rve"],
                                        self.k + 1)
        links = pe_links.pe_links(self.seqs, ref_reads, self.k, ctx.device)
        ctx.work.update(links.work)
        ctx.work.update(
            sat_entries=int(torch.diagonal(links.short_mat).sum()),
            pair_links=int(links.node_mat.sum()),
            short_links=int(links.short_mat.sum()))
        N = len(self.ids)
        worst = 0
        for rec in kept:
            node, short, bad = matrices(rec["result"], N, ctx.device)
            worst = max(worst, bad + check.links_differ(
                node, short, links.node_mat, links.short_mat))
        return {"pe_links_differ": worst}
