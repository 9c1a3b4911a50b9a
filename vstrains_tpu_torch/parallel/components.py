"""Per-connected-component parallel disentanglement + extension — the
PyTorch port of `vstrains_tpu/parallel/components.py`.

metaSPAdes multi-sample graphs decompose into independent weakly-connected
components (BASELINE.json config 5); every decision in the
disentanglement/extension stages is component-local (branch splits, link
choices, coverage subtraction), so components are an embarrassingly
parallel axis — the closest analogue of expert parallelism in this
workload (SURVEY.md §2). The reference processes the whole graph
monolithically; component order only affects strain numbering.

Components are serialized to GFA text + plain dicts, so workers can be
local processes or ranks of a torch.distributed world (the worker
function is pure). A worker gets the run's device as a string and opens
`device.run_on` itself: a spawned process inherits neither the run's
ContextVar nor torch's default device, and without them its graph passes
would resolve to "cuda".

Global coverage medians (the delta thresholds) are computed over the whole
graph before splitting, matching the reference's global medians.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Set, Tuple

from vstrains_tpu_torch.core.graph import GraphView

_LOG = logging.getLogger(__name__)


def weakly_connected_components(view: GraphView) -> List[List[str]]:
    """Node-id groups, ordered by first node appearance."""
    seen: Set[str] = set()
    comps: List[List[str]] = []
    for start_id, start in view.nodes.items():
        if start_id in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start_id)
        while stack:
            v = stack.pop()
            comp.append(v.vid)
            for nb in v.all_neighbors():
                if nb.vid in view.nodes and nb.vid not in seen:
                    seen.add(nb.vid)
                    stack.append(nb)
        comps.append(sorted(comp, key=list(view.nodes).index))
    return comps


def component_payloads(view: GraphView, contig_dict: dict, pe_info: dict,
                       dcpy_pe_info: dict) -> List[dict]:
    """Split the graph + contigs + PE info into standalone per-component
    payloads (GFA text + plain dicts, process-portable)."""
    comps = weakly_connected_components(view)
    payloads = []
    for comp in comps:
        comp_set = set(comp)
        gfa_lines = []
        for vid in comp:
            v = view.nodes[vid]
            gfa_lines.append(f"S\t{vid}\t{v.seq}\tDP:f:{v.dp}")
        for (u, w), e in view.edges.items():
            if u in comp_set and w in comp_set:
                gfa_lines.append(f"L\t{u}\t+\t{w}\t+\t{e.overlap}M")
        sub_contigs = {cno: [list(c), ln, cov]
                       for cno, (c, ln, cov) in contig_dict.items()
                       if all(n in comp_set for n in c)}
        sub_pe = {k: c for k, c in pe_info.items()
                  if k[0] in comp_set and k[1] in comp_set}
        sub_dcpy = {k: c for k, c in dcpy_pe_info.items()
                    if k[0] in comp_set and k[1] in comp_set}
        payloads.append({
            "gfa_text": "\n".join(gfa_lines) + "\n",
            "contig_dict": sub_contigs,
            "pe_info": sub_pe,
            "dcpy_pe_info": sub_dcpy,
        })
    return payloads


def process_component(payload: dict, delta: float,
                      device: str) -> Dict[str, list]:
    """Pure worker: disentangle + extend one component on `device` (the
    run's device, "cuda" or "cpu"), return its strain dict. Runs the same
    stages 6-8 as the monolithic pipeline; the extension delta is
    computed component-locally (the monolithic path uses the global
    post-disentanglement median, SPAdes.py:237)."""
    from vstrains_tpu_torch.device import resolve_device, run_on

    with run_on(resolve_device(device)):
        return _process_component(payload, delta)


def _process_component(payload: dict, delta: float) -> Dict[str, list]:
    import tempfile

    import numpy

    from vstrains_tpu_torch.algos.branches import increment_nt_branch_coverage
    from vstrains_tpu_torch.algos.decomposition import iter_graph_disentanglement
    from vstrains_tpu_torch.algos.extension import best_matching, path_extension
    from vstrains_tpu_torch.core.gfa import load_flipped_gfa
    from vstrains_tpu_torch.ops.graph_ops import assign_edge_flow

    logger = logging.getLogger("component")
    with tempfile.NamedTemporaryFile("w", suffix=".gfa",
                                     delete=False) as tf:
        tf.write(payload["gfa_text"])
        gfa_path = tf.name
    try:
        view = load_flipped_gfa(gfa_path, logger)
    finally:
        os.unlink(gfa_path)
    from vstrains_tpu_torch.core.pe_store import PEInfo

    assign_edge_flow(view)
    contig_dict = payload["contig_dict"]
    pe_info = PEInfo(payload["pe_info"])
    view = iter_graph_disentanglement(view, contig_dict, pe_info, delta,
                                      None, logger)
    full_link = best_matching(view, contig_dict, pe_info, logger)
    increment_nt_branch_coverage(view, logger)
    p_delta = 0.05 * float(numpy.median(
        [v.dp for v in view.graph.vertices()]))
    strain_dict, _usages, _view = path_extension(
        view, contig_dict, full_link, dict(payload["dcpy_pe_info"]),
        p_delta, None, logger)
    return strain_dict


def _allgather_json(obj):
    """Every rank's JSON-serializable object, indexed by rank (self
    included): one `all_gather_object` over the default process group.
    Strain dicts are tiny host data; JSON keeps what travels to plain
    lists, dicts, strings and numbers, as the JAX package's byte
    exchange does."""
    import json

    import numpy as np
    import torch.distributed as dist

    def _np_default(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        raise TypeError(f"not JSON-serializable: {type(o)!r}")

    raw = json.dumps(obj, default=_np_default)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, raw)
    return [json.loads(x) for x in out]


def run_components_multihost(view: GraphView, contig_dict: dict,
                             pe_info: dict, dcpy_pe_info: dict,
                             delta: float, device: str,
                             logger: logging.Logger = None
                             ) -> Dict[str, list]:
    """Per-component extraction sharded round-robin over the ranks of the
    default torch.distributed process group — the cross-host dispatch of
    the same worker payloads the local process pool runs (docstring at
    module top).

    Every rank holds the replicated graph and PE info (they are small
    — viral genomes), extracts the components with index % world_size ==
    rank on `device`, and the per-component strain dicts are exchanged
    with `_allgather_json`, so all ranks return the identical merged
    result in deterministic component order."""
    import torch.distributed as dist

    logger = logger or _LOG
    rank, nproc = dist.get_rank(), dist.get_world_size()
    payloads = component_payloads(view, contig_dict, pe_info, dcpy_pe_info)
    mine = {ci: process_component(payloads[ci], delta, device)
            for ci in range(rank, len(payloads), nproc)}
    logger.info("per-component multihost: process %d/%d extracted %d of "
                "%d components", rank, nproc, len(mine), len(payloads))
    results: Dict[int, dict] = {}
    for per_proc in _allgather_json(mine):
        results.update({int(ci): sd for ci, sd in per_proc.items()})
    merged: Dict[str, list] = {}
    for ci in range(len(payloads)):
        for sno, rec in results.get(ci, {}).items():
            name = sno if len(payloads) == 1 else f"{sno}c{ci}"
            merged[name] = rec
    return merged


def run_components(view: GraphView, contig_dict: dict, pe_info: dict,
                   dcpy_pe_info: dict, delta: float, device: str,
                   workers: int = 1,
                   logger: logging.Logger = None) -> Dict[str, list]:
    """Disentangle+extend every component on `device` (optionally in
    parallel worker processes) and merge strains with component-suffixed
    ids."""
    logger = logger or _LOG
    payloads = component_payloads(view, contig_dict, pe_info, dcpy_pe_info)
    logger.info("per-component extraction: %d components, %d workers",
                len(payloads), workers)
    if workers > 1 and len(payloads) > 1:
        # spawn: fork is unsafe in a process with live CUDA state and
        # threads; a spawned worker starts from a fresh import
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            results = list(ex.map(process_component, payloads,
                                  [delta] * len(payloads),
                                  [str(device)] * len(payloads)))
    else:
        results = [process_component(p, delta, str(device))
                   for p in payloads]
    merged: Dict[str, list] = {}
    for ci, strain_dict in enumerate(results):
        for sno, rec in strain_dict.items():
            name = sno if len(results) == 1 else f"{sno}c{ci}"
            merged[name] = rec
    return merged
