"""Tip removal for cyclic graphs (reference component C10).

Parity: /root/reference/utils/VStrains_Preprocess.py:127-401
(paths_from_src, paths_to_tgt, tip_removal_s, tip_removal). The reference
scores tip-vs-path similarity by shelling out to minimap2
(`cand_collapse_path`, Preprocess:266-333, mean nmatch/nblock per path);
we score with the same dual-hash k-mer machinery as the PE engine: the
fraction of the tip's k-mers contained in the candidate path (either
strand). Identical sequences score 1.0; the 0.99 accept threshold carries
over.

The reference gates this on cyclic graphs and does not call it from its
live pipeline (SPAdes.py never invokes tip_removal_s); ours runs it in
the preprocess stage when the CLI --tip-removal flag is set.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from vstrains_tpu_torch.algos.dag import graph_is_DAG
from vstrains_tpu_torch.algos.pathmath import path_len, path_to_seq
from vstrains_tpu_torch.core.graph import GraphView, Vertex
from vstrains_tpu_torch.core.seq import encode_seq, revcomp_codes, window_hashes_np

_LOG = logging.getLogger(__name__)

_SCORE_K = 21  # k-mer size for containment scoring


def kmer_containment(query: str, target: str, k: int = _SCORE_K) -> float:
    """Fraction of query k-mers present in target (either strand)."""
    qc = encode_seq(query)
    if len(query) < k:
        return 1.0 if query in target else 0.0
    qh1, qh2, qv = window_hashes_np(qc, k)
    tc = encode_seq(target)
    if len(target) < k:
        return 0.0
    th1, th2, tv = window_hashes_np(tc, k)
    rc = revcomp_codes(tc)
    rh1, rh2, rv = window_hashes_np(rc, k)
    tset = set(zip(th1[tv].tolist(), th2[tv].tolist()))
    tset.update(zip(rh1[rv].tolist(), rh2[rv].tolist()))
    qkeys = list(zip(qh1[qv].tolist(), qh2[qv].tolist()))
    if not qkeys:
        return 0.0
    hits = sum(1 for key in qkeys if key in tset)
    return hits / len(qkeys)


def paths_from_src(view: GraphView, self_node: Vertex, src: Vertex,
                   maxlen: int) -> List[List[Vertex]]:
    """All paths from src forward until length >= maxlen
    (Preprocess:127-156)."""
    visited = {u: (u.vid not in view.nodes) for u in view.graph.vertices()}
    visited[self_node] = True
    all_path: List[List[Vertex]] = []

    def dfs(u: Vertex, curr: List[Vertex]):
        visited[u] = True
        curr.append(u)
        if path_len(view, curr) >= maxlen:
            all_path.append(list(curr))
        else:
            for v in u.out_neighbors():
                if not visited[v]:
                    dfs(v, curr)
        curr.pop()
        visited[u] = False

    dfs(src, [])
    return all_path


def paths_to_tgt(view: GraphView, self_node: Vertex, tgt: Vertex,
                 maxlen: int) -> List[List[Vertex]]:
    """All paths into tgt backward until length >= maxlen
    (Preprocess:159-188)."""
    visited = {u: (u.vid not in view.nodes) for u in view.graph.vertices()}
    visited[self_node] = True
    all_path: List[List[Vertex]] = []

    def dfs(v: Vertex, curr: List[Vertex]):
        visited[v] = True
        curr.insert(0, v)
        if path_len(view, curr) >= maxlen:
            all_path.append(list(curr))
        else:
            for u in v.in_neighbors():
                if not visited[u]:
                    dfs(u, curr)
        curr.pop(0)
        visited[v] = False

    dfs(tgt, [])
    return all_path


def _cand_collapse_path(view: GraphView, from_node: Vertex,
                        to_paths: List[List[Vertex]], accept_rate: float,
                        logger: logging.Logger):
    """Most similar candidate path by k-mer containment, or None
    (replaces the minimap2 scoring of Preprocess:266-333)."""
    if not to_paths:
        return None
    tip_seq = from_node.seq
    scored = []
    for i, path in enumerate(to_paths):
        score = kmer_containment(tip_seq, path_to_seq(view, path))
        scored.append((i, score))
    best = sorted(scored, key=lambda t: t[1], reverse=True)
    logger.debug("Tip Node: %s %s", from_node.vid, best[:3])
    if best[0][1] >= accept_rate:
        return to_paths[best[0][0]]
    return None


def _remove_tip(view: GraphView, from_node: Vertex,
                to_path: List[Vertex], logger: logging.Logger) -> None:
    """Collapse a tip into the path: add its depth, gray it out
    (Preprocess:245-264)."""
    from_node.color = "gray"
    pending_dp = from_node.dp
    for node in to_path:
        node.dp += pending_dp
    view.nodes.pop(from_node.vid)
    for e in from_node.all_edges():
        e.color = "gray"
    logger.debug("Tip Node %s collapsed to path %s", from_node.vid,
                 [n.vid for n in to_path])


def tip_removal(view: GraphView, accept_rate: float,
                logger: logging.Logger) -> bool:
    """One sweep over source and sink tips; returns True when nothing was
    removed (fixed point reached) — same contract as Preprocess:233-401."""
    is_removed = True
    src_nodes = []
    tgt_nodes = []
    for node in view.nodes.values():
        if node.in_degree() + node.out_degree() == 0:
            continue
        elif node.in_degree() == 0:
            src_nodes.append(node)
        elif node.out_degree() == 0:
            tgt_nodes.append(node)

    src_nodes = sorted(src_nodes, key=lambda x: x.dp)
    for src in src_nodes:
        src_len = path_len(view, [src])
        potential = []
        for out_branch in src.out_neighbors():
            if out_branch.vid not in view.nodes:
                continue
            for in_tgt in out_branch.in_neighbors():
                if in_tgt.vid == src.vid:
                    continue
                if in_tgt.vid not in view.nodes:
                    continue
                potential.extend(paths_to_tgt(view, src, in_tgt, src_len))
        cand = _cand_collapse_path(view, src, potential, accept_rate,
                                   logger)
        if cand is not None:
            _remove_tip(view, src, cand, logger)
            is_removed = False

    tgt_nodes = sorted(tgt_nodes, key=lambda x: x.dp)
    for tgt in tgt_nodes:
        tgt_len = path_len(view, [tgt])
        potential = []
        for in_branch in tgt.in_neighbors():
            if in_branch.vid not in view.nodes:
                continue
            for out_src in in_branch.out_neighbors():
                if out_src.vid == tgt.vid:
                    continue
                if out_src.vid not in view.nodes:
                    continue
                potential.extend(paths_from_src(view, tgt, out_src,
                                                tgt_len))
        cand = _cand_collapse_path(view, tgt, potential, accept_rate,
                                   logger)
        if cand is not None:
            _remove_tip(view, tgt, cand, logger)
            is_removed = False
    return is_removed


def tip_removal_s(view: GraphView, contig_dict: dict,
                  logger: logging.Logger = None,
                  accept_rate: float = 0.99) -> None:
    """Iterate tip removal to a fixed point on cyclic graphs; split contigs
    that crossed removed tips (Preprocess:191-230)."""
    logger = logger or _LOG
    if not graph_is_DAG(view):
        logger.info("cyclic graph: collapsing tips..")
        tip_removed = False
        while not tip_removed:
            tip_removed = tip_removal(view, accept_rate, logger)
        for cno, [contig, _, ccov] in list(contig_dict.items()):
            if not all(no in view.nodes for no in contig):
                subcontigs = []
                curr_contig: List[str] = []
                add_last = False
                for no in contig:
                    if no in view.nodes:
                        add_last = True
                        curr_contig.append(no)
                    else:
                        add_last = False
                        if curr_contig:
                            subcontigs.append(curr_contig[:])
                        curr_contig = []
                if add_last:
                    subcontigs.append(curr_contig[:])
                contig_dict.pop(cno)
                for i, subc in enumerate(subcontigs):
                    sublen = path_len(view,
                                      [view.nodes[c] for c in subc])
                    contig_dict[cno + "^" + str(i)] = [subc, sublen, ccov]
    else:
        logger.info("acyclic graph: tip collapse not needed")
    logger.info("done")
