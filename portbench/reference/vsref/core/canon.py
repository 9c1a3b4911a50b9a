"""Strandedness canonization: bidirected GFA -> single-orientation digraph.

The SPAdes graph is bidirected (each segment usable as + or -). We create the
two oriented twins per segment, then run a max-coverage-seeded DFS flip that
picks one orientation per node and rewires the unpicked twin's edges into the
picked frame; ambiguous nodes keep both twins as `X` and `-X`.

Semantics parity with VStrains' utils/VStrains_IO.py:27-269
(gfa_to_graph + flip_graph_bfs + reduce_graph), with one deliberately pinned
total order: the reference iterates `set(v.all_edges())` whose order is a
CPython set artifact; we iterate adjacency insertion order (out-edges then
in-edges) so runs are reproducible.

This is a one-shot O(V+E) host pass on a tiny graph; no device work.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

from portbench.reference.vsref.core.gfa import GfaFormatError, parse_gfa
from portbench.reference.vsref.core.graph import (AssemblyGraph, GraphView, Vertex,
                                     new_view)
from portbench.reference.vsref.core.seq import revcomp_str

_LOG = logging.getLogger(__name__)


def load_gfa_canonized(gfa_path: str,
                       logger: logging.Logger = None,
                       init_ori: int = 1) -> GraphView:
    """Full equivalent of the reference's gfa_to_graph: parse, flip, reduce."""
    logger = logger or _LOG
    logger.info("reading GFA into the graph substrate")
    segments, links = parse_gfa(gfa_path)
    logger.info("Parsed gfa file: %d segments, %d links",
                len(segments), len(links))

    graph = AssemblyGraph()
    node_dict: Dict[str, Tuple[Vertex, Vertex]] = {}
    dp_dict: Dict[str, float] = {}
    edge_dict: Dict[Tuple[str, int, str, int], object] = {}

    for seg in segments:
        v_pos = graph.add_vertex(seg.name, seg.seq, seg.dp)
        v_pos.ori = 1
        v_pos.visited = -1
        v_neg = graph.add_vertex(seg.name, revcomp_str(seg.seq), seg.dp)
        v_neg.ori = -1
        v_neg.visited = -1
        node_dict[seg.name] = (v_pos, v_neg)
        dp_dict[seg.name] = seg.dp

    for link in links:
        u_pos, u_neg = node_dict[link.src]
        v_pos, v_neg = node_dict[link.dst]
        u = u_pos if link.src_ori == "+" else u_neg
        v = v_pos if link.dst_ori == "+" else v_neg

        if (link.src, u.ori, link.dst, v.ori) in edge_dict:
            raise GfaFormatError(
                "parallel edge found, invalid case in assembly graph")
        if link.src == link.dst:
            # self-loop segment: neutralize by lowercasing (its k-mers can
            # then never match uppercase read k-mers); edge dropped.
            # (reference behavior: VStrains_IO.py:117-120)
            u.seq = u.seq.lower()
            v.seq = v.seq.lower()
            continue
        e = graph.add_edge(u, v, overlap=link.overlap)
        edge_dict[(link.src, u.ori, link.dst, v.ori)] = e

    graph, simp_node_dict, simp_edge_dict = _flip_graph(
        graph, node_dict, edge_dict, dp_dict, logger, init_ori)
    return _reduce(graph, simp_node_dict, simp_edge_dict)


def _reverse_edge(graph: AssemblyGraph, e, node_dict, edge_dict):
    """Rewire an edge incident to an unpicked twin into the picked frame:
    (s, t) becomes (twin(t), twin(s))."""
    s, t = e.source, e.target
    edge_dict.pop((s.vid, s.ori, t.vid, t.ori))
    s_pos, s_neg = node_dict[s.vid]
    t_pos, t_neg = node_dict[t.vid]
    ns = t_pos if t.ori == -1 else t_neg
    nt = s_pos if s.ori == -1 else s_neg
    overlap = e.overlap
    graph.remove_edge(e)
    ne = graph.add_edge(ns, nt, overlap=overlap)
    edge_dict[(ns.vid, ns.ori, nt.vid, nt.ori)] = ne
    return ne


def _flip_graph(graph, node_dict, edge_dict, dp_dict, logger, init_ori=1):
    """Pick one orientation per node by traversal from max-depth seeds.

    Parity: VStrains_IO.py:137-269 (the reference's `fifo_queue` is popped
    from the tail, i.e. DFS order; reproduced faithfully).
    """
    logger.info("canonizing strand orientation..")
    pick_dict: Dict[str, str] = {}
    while dp_dict:
        # max-depth seed; first max in insertion order (IO.py:152-156)
        seed = max(dp_dict, key=dp_dict.get)
        s_pos, s_neg = node_dict[seed]
        s_pos.visited = 0
        s_neg.visited = 0
        stack = [(node_dict[seed], init_ori)]

        while stack:
            (v_pos, v_neg), ori = stack.pop()
            dp_dict.pop(v_pos.vid)

            if ori == 1:
                u = v_pos
                pick_dict[u.vid] = "+"
                for e in list(dict.fromkeys(v_neg.all_edges())):
                    _reverse_edge(graph, e, node_dict, edge_dict)
            else:
                u = v_neg
                pick_dict[u.vid] = "-"
                for e in list(dict.fromkeys(v_pos.all_edges())):
                    _reverse_edge(graph, e, node_dict, edge_dict)

            v_pos.visited = 1
            v_neg.visited = 1
            for adj in u.all_neighbors():
                if adj.visited == -1:
                    a_pos, a_neg = node_dict[adj.vid]
                    a_pos.visited = 0
                    a_neg.visited = 0
                    stack.append((node_dict[adj.vid], adj.ori))

    logger.info("verifying orientation picks..")
    assert len(pick_dict) == len(node_dict)
    for key, item in list(pick_dict.items()):
        v_pos, v_neg = node_dict[key]
        if item == "+":
            if v_neg.in_degree() + v_neg.out_degree() > 0:
                logger.debug("pick ambiguous found for %s, keep both twins",
                             key)
                pick_dict[key] = "t"
        else:
            if v_pos.in_degree() + v_pos.out_degree() > 0:
                logger.debug("pick ambiguous found for %s, keep both twins",
                             key)
                pick_dict[key] = "t"
    logger.info("orientation picks verified")

    simp_node_dict: Dict[str, Vertex] = {}
    for seg_no, pick in pick_dict.items():
        v_pos, v_neg = node_dict[seg_no]
        if pick == "+":
            simp_node_dict[seg_no] = v_pos
        elif pick == "-":
            v_neg.vid = "-" + seg_no
            simp_node_dict[v_neg.vid] = v_neg
        else:
            simp_node_dict[seg_no] = v_pos
            v_neg.vid = "-" + seg_no
            simp_node_dict[v_neg.vid] = v_neg

    simp_edge_dict = {}
    for e in edge_dict.values():
        simp_edge_dict[(e.source.vid, e.target.vid)] = e
    logger.info("done")
    return graph, simp_node_dict, simp_edge_dict


def _reduce(unsimp_graph, simp_node_dict, simp_edge_dict) -> GraphView:
    """Rebuild a clean digraph with only the picked orientations
    (parity: VStrains_IO.py:272-295)."""
    view = new_view()
    for no, node in simp_node_dict.items():
        view.add_vertex(node.vid, node.dp, node.seq)
    for (u, w), e in simp_edge_dict.items():
        view.add_edge(view.nodes[u], view.nodes[w], e.overlap,
                      flow=e.flow)
    return view
