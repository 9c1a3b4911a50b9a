"""Simple-path compactification: merge maximal non-branching paths into
single `a&b&c` nodes, re-wiring boundary edges and aggregating PE-link info.

Parity: VStrains' utils/VStrains_Utilities.py:383-574 (simp_path,
simple_paths_to_dict, simp_path_compactification). The reference reads
boundary adjacency from a full graph copy taken before mutation; we snapshot
the same information up front, which is equivalent and avoids the copy.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy

from portbench.reference.vsref.algos.pathmath import path_len, path_to_seq
from portbench.reference.vsref.core.pe_store import pe_pop_nodes
from portbench.reference.vsref.core.graph import GraphView, Vertex

_LOG = logging.getLogger(__name__)


def simp_path(view: GraphView) -> List[List[Vertex]]:
    """Maximal chains of simple edges (source out-degree 1, target in-degree
    1; Utilities:383-418)."""
    out_edge = {}
    in_edge = {}
    for e in view.edges.values():
        src = e.source
        target = e.target
        if src.vid not in view.nodes or target.vid not in view.nodes:
            continue
        if src.out_degree() == 1 and target.in_degree() == 1:
            if src is not target:
                in_edge[src] = e
                out_edge[target] = e

    def extend_path(p: List[Vertex]) -> List[Vertex]:
        v = p[-1]
        while v in in_edge:
            p.append(in_edge[v].target)
            v = p[-1]
        return p

    simple_paths = []
    for v, e in in_edge.items():
        if v not in out_edge:
            simple_paths.append(extend_path([e.source, e.target]))
    return simple_paths


def simple_paths_to_dict(view: GraphView) -> Dict[str, list]:
    """Simple paths as a contig-like dict (Utilities:421-431)."""
    simple_paths = simp_path(view)
    simp_path_dict = {}
    for id_, p in enumerate(simple_paths):
        pids = [n.vid for n in p]
        simp_path_dict[str(id_)] = [pids, path_len(view, p),
                                    float(numpy.mean([n.dp for n in p]))]
    return simp_path_dict


def simp_path_compactification(view: GraphView, contig_dict, pe_info,
                               logger: logging.Logger = None) -> None:
    """Contract each simple path into one `a&b&...` node
    (Utilities:434-574).

    PE-link info of members aggregates onto the merged id; contigs are
    rewritten through the member->merged-id map.
    """
    logger = logger or _LOG
    logger.info("merging maximal simple paths..")
    simp_path_dict = simple_paths_to_dict(view)

    node_to_simp_node = {id_: id_ for id_ in view.nodes.keys()}

    # snapshot pre-mutation boundary info (the reference's graph copy)
    snapshots = []
    for cno, (contig, _, ccov) in list(simp_path_dict.items()):
        src = contig[0]
        tgt = contig[-1]
        merged_id = "&".join(contig)
        cseq = path_to_seq(view, [view.nodes[n] for n in contig])
        in_edges = [(e.source.vid, src, e.overlap)
                    for e in view.nodes[src].in_e]
        out_edges = [(tgt, e.target.vid, e.overlap)
                     for e in view.nodes[tgt].out_e]
        snapshots.append((cno, contig, ccov, src, tgt, merged_id, cseq,
                          in_edges, out_edges))

    contig_info = []
    for (cno, contig, ccov, src, tgt, merged_id, cseq,
         in_edges, out_edges) in snapshots:
        for i in range(len(contig)):
            no = contig[i]
            node_to_simp_node[no] = merged_id
            view.remove_vertex(no)
            if i != len(contig) - 1:
                view.remove_edge(contig[i], contig[i + 1])
        cv = view.add_vertex(merged_id, ccov, cseq)
        contig_info.append([src, tgt, cno, cv, in_edges, out_edges])
        if pe_info is not None:
            if hasattr(pe_info, "items_of"):
                # index-driven and sparse: O(sum of member pair-degrees)
                # instead of O(N x members); zero pairs read as 0
                # implicitly
                acc: Dict[str, int] = {}
                members = set(contig)
                for sub_id in contig:
                    for (ku, kv), val in pe_info.items_of(sub_id):
                        partner = kv if ku == sub_id else ku
                        if partner in members:
                            continue
                        acc[partner] = acc.get(partner, 0) + (val or 0)
                for nno, total in acc.items():
                    if total and nno in view.nodes:
                        key = (min(merged_id, nno), max(merged_id, nno))
                        pe_info[key] = total
            else:
                for nno in list(view.nodes.keys()):
                    key = (min(merged_id, nno), max(merged_id, nno))
                    pe_info[key] = 0
                    if nno != merged_id:
                        for sub_id in contig:
                            pe_info[key] += pe_info[
                                (min(sub_id, nno), max(sub_id, nno))]
            pe_pop_nodes(pe_info, contig)

    # recover boundary edges around the merged nodes (Utilities:501-549)
    for [_, _, _, node, in_edges, out_edges] in contig_info:
        for u, v, o in in_edges:
            if (u in view.nodes
                    and (u, node.vid) not in view.edges):
                view.add_edge(view.nodes[u], node, o)
            for [_, tgt2, _, in_node, _, _] in contig_info:
                if (tgt2 == u
                        and (in_node.vid, node.vid) not in view.edges):
                    view.add_edge(in_node, node, o)
        for u, v, o in out_edges:
            if (v in view.nodes
                    and (node.vid, v) not in view.edges):
                view.add_edge(node, view.nodes[v], o)
            for [src2, _, _, out_node, _, _] in contig_info:
                if (src2 == v
                        and (node.vid, out_node.vid) not in view.edges):
                    view.add_edge(node, out_node, o)

    # rewrite contigs through the merged ids (Utilities:551-572)
    if contig_dict is not None:
        for cno, (contig, _, ccov) in list(contig_dict.items()):
            new_contig = []
            for no in contig:
                if node_to_simp_node[no] == no:
                    new_contig.append(no)
                else:
                    if len(new_contig) == 0:
                        new_contig.append(node_to_simp_node[no])
                    elif node_to_simp_node[no] != new_contig[-1]:
                        new_contig.append(node_to_simp_node[no])
            logger.debug("cno: %s from %s to %s", cno, contig, new_contig)
            contig_dict[cno] = [
                new_contig,
                path_len(view, [view.nodes[no] for no in new_contig]),
                ccov]
    logger.info("done")
