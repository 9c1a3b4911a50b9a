"""Path arithmetic over the assembly graph: lengths, coverages, sequences.

Semantics parity with VStrains' utils/VStrains_Utilities.py:839-921.
Host-side: these run on single paths (tiny); batched per-edge numeric work
lives in ops/graph_ops.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from portbench.reference.vsref.core.graph import GraphView, Vertex


def path_len(view: GraphView, path: Sequence[Vertex]) -> int:
    """Total sequence length of a path, overlap-corrected
    (Utilities:839-850)."""
    lens = sum(len(u.seq) for u in path)
    for i in range(len(path) - 1):
        e = view.graph.edge(path[i], path[i + 1])
        if e is not None:
            lens -= e.overlap
    return lens


def contig_flow(view: GraphView, contig: Sequence[str]) -> List[float]:
    """Edge flows along a contig (Utilities:878-890)."""
    if len(contig) < 2:
        return []
    return [view.edges[(contig[i], contig[i + 1])].flow
            for i in range(len(contig) - 1)]


def path_cov(view: GraphView, contig: Sequence[str]) -> float:
    """Coverage of a contig: min edge flow, or node depth if single node
    (Utilities:853-862)."""
    eflow = contig_flow(view, contig)
    if len(eflow) < 1:
        return view.nodes[contig[0]].dp
    return min(eflow)


def contig_edges(contig: Sequence[str]) -> List[Tuple[str, str]]:
    """Consecutive id pairs of a contig (Utilities:865-875)."""
    if len(contig) < 2:
        return []
    return [(contig[i], contig[i + 1]) for i in range(len(contig) - 1)]


def path_to_seq(view: GraphView, path: Sequence[Vertex]) -> str:
    """Concatenate node sequences along a path, trimming edge overlaps
    (Utilities:909-921)."""
    seq = []
    for i, u in enumerate(path):
        if i == len(path) - 1:
            seq.append(u.seq)
        else:
            e = view.graph.edge(u, path[i + 1])
            overlap = e.overlap if e is not None else 0
            seq.append(u.seq if overlap == 0 else u.seq[:-overlap])
    return "".join(seq)


def path_ids_to_seq(view: GraphView, path_ids: Sequence[str]) -> str:
    """Same as path_to_seq but from node ids (Utilities:893-906)."""
    return path_to_seq(view, [view.nodes[i] for i in path_ids])
