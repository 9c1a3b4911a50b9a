"""Host-side assembly-graph substrate with dense device-tensor views.

Replaces graph-tool (the reference's C++ dependency, used throughout
VStrains' utils/VStrains_Utilities.py) with a purpose-built ordered
graph:

  * vertices/edges keep *deterministic insertion order* — the reference's
    semantics lean on Python dict ordering and graph-tool adjacency order for
    every greedy tie-break, so ordering is part of the spec, not an accident;
  * mutation (split/merge/delete) is O(1) host bookkeeping on a graph of at
    most a few thousand nodes (viral genomes);
  * all *batched numeric* work (edge-flow assignment, histograms, pair
    matrices, frontier iterations) runs on device via the `GraphTensors`
    dense view (ops/graph_ops.py) — the graph is the small state, reads are
    the big tensor workload (see docs/ARCHITECTURE.md).

The `GraphView` (graph + live node/edge dicts) mirrors the reference's
(graph, simp_node_dict, simp_edge_dict) triple
(VStrains' utils/VStrains_IO.py:272-295), and `GraphView.compact()`
replaces its write-GFA-then-reload "reinit" idiom
(VStrains' utils/VStrains_IO.py:630-642) with an in-memory rebuild that
produces the identical ordering a disk round-trip would.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

BLACK = "black"
GRAY = "gray"


class Vertex:
    __slots__ = ("idx", "vid", "seq", "dp", "color", "ori", "visited",
                 "out_e", "in_e")

    def __init__(self, idx: int, vid: str, seq: str, dp: float,
                 color: str = BLACK):
        self.idx = idx
        self.vid = vid
        self.seq = seq
        self.dp = dp
        self.color = color
        self.ori = 0        # parse-time only: 1 = +, -1 = -
        self.visited = -1   # parse-time only
        self.out_e: List["Edge"] = []
        self.in_e: List["Edge"] = []

    # --- adjacency (insertion order; all_* = out then in, matching
    # graph-tool's directed all_edges()/all_neighbors() order) ---
    def out_edges(self) -> List["Edge"]:
        return list(self.out_e)

    def in_edges(self) -> List["Edge"]:
        return list(self.in_e)

    def all_edges(self) -> List["Edge"]:
        return list(self.out_e) + list(self.in_e)

    def out_neighbors(self) -> List["Vertex"]:
        return [e.target for e in self.out_e]

    def in_neighbors(self) -> List["Vertex"]:
        return [e.source for e in self.in_e]

    def all_neighbors(self) -> List["Vertex"]:
        return [e.target for e in self.out_e] + [e.source for e in self.in_e]

    def out_degree(self) -> int:
        return len(self.out_e)

    def in_degree(self) -> int:
        return len(self.in_e)

    # ordering used by e.g. the final link pass (Extension:768-771 iterates
    # vertex pairs by descriptor order)
    def __lt__(self, other: "Vertex") -> bool:
        return self.idx < other.idx

    def __gt__(self, other: "Vertex") -> bool:
        return self.idx > other.idx

    def __repr__(self):
        return f"V({self.vid!r}, dp={self.dp}, {self.color})"


class Edge:
    __slots__ = ("source", "target", "overlap", "flow", "color")

    def __init__(self, source: Vertex, target: Vertex, overlap: int = 0,
                 flow: float = 0.0, color: str = BLACK):
        self.source = source
        self.target = target
        self.overlap = overlap
        self.flow = flow
        self.color = color

    def __repr__(self):
        return f"E({self.source.vid!r}->{self.target.vid!r}, {self.color})"


class AssemblyGraph:
    """Raw vertex/edge storage (including gray/dead elements)."""

    def __init__(self):
        self._vertices: List[Vertex] = []
        self._edges: List[Edge] = []

    def add_vertex(self, vid: str = "UD", seq: str = "", dp: float = 0.0,
                   color: str = BLACK) -> Vertex:
        v = Vertex(len(self._vertices), vid, seq, dp, color)
        self._vertices.append(v)
        return v

    def add_edge(self, source: Vertex, target: Vertex, overlap: int = 0,
                 flow: float = 0.0, color: str = BLACK) -> Edge:
        e = Edge(source, target, overlap, flow, color)
        source.out_e.append(e)
        target.in_e.append(e)
        self._edges.append(e)
        return e

    def remove_edge(self, e: Edge) -> None:
        """Physically unlink an edge (reference: Graph.remove_edge)."""
        e.source.out_e.remove(e)
        e.target.in_e.remove(e)
        self._edges.remove(e)

    def edge(self, u: Vertex, v: Vertex) -> Optional[Edge]:
        for e in u.out_e:
            if e.target is v:
                return e
        return None

    def vertices(self) -> List[Vertex]:
        return list(self._vertices)

    def edges(self) -> List[Edge]:
        return list(self._edges)

    def num_vertices(self) -> int:
        return len(self._vertices)

    def num_edges(self) -> int:
        return len(self._edges)


@dataclass
class GraphTensors:
    """Dense device-facing view of a GraphView.

    Node axis is the live-node insertion order; `ids` maps dense index ->
    string id (host-side interning of the reference's `X*i` / `a&b` id
    algebra — the device only ever sees dense ints).
    """
    ids: List[str]
    dp: np.ndarray            # f32 [N]
    seq_len: np.ndarray       # i32 [N]
    edge_src: np.ndarray      # i32 [E]
    edge_dst: np.ndarray      # i32 [E]
    edge_overlap: np.ndarray  # i32 [E]
    edge_flow: np.ndarray     # f32 [E]

    @property
    def num_nodes(self) -> int:
        return len(self.ids)

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])


@dataclass
class GraphView:
    """A graph plus its live node/edge dicts (insertion-ordered)."""
    graph: AssemblyGraph
    nodes: Dict[str, Vertex]
    edges: Dict[Tuple[str, str], Edge]

    # ---- mutators (parity with VStrains_Utilities.py:934-1000) ----
    def add_vertex(self, vid: str, dp: float, seq: str,
                   color: str = BLACK) -> Vertex:
        v = self.graph.add_vertex(vid, seq, dp, color)
        self.nodes[vid] = v
        return v

    def remove_vertex(self, vid: str, color: str = GRAY) -> Vertex:
        v = self.nodes.pop(vid)
        v.color = color
        return v

    def add_edge(self, src: Vertex, tgt: Vertex, overlap: int,
                 flow: float = 0.0, color: str = BLACK) -> Edge:
        e = self.graph.add_edge(src, tgt, overlap, flow, color)
        self.edges[(src.vid, tgt.vid)] = e
        return e

    def remove_edge(self, src_id: str, tgt_id: str,
                    color: str = GRAY) -> Edge:
        e = self.edges.pop((src_id, tgt_id))
        e.color = color
        return e

    # ---- compaction (replaces store_reinit_graph's disk round-trip,
    # VStrains_IO.py:630-642; ordering identical to write+reload) ----
    def compact(self) -> "GraphView":
        g = AssemblyGraph()
        nodes: Dict[str, Vertex] = {}
        edges: Dict[Tuple[str, str], Edge] = {}
        for vid, v in self.nodes.items():
            if v.color == BLACK:
                nodes[vid] = g.add_vertex(vid, v.seq, v.dp)
        for (uid, vid), e in self.edges.items():
            if uid not in nodes or vid not in nodes:
                continue
            if self.nodes[uid].color != BLACK or self.nodes[vid].color != BLACK:
                continue
            if e.color != BLACK:
                continue
            edges[(uid, vid)] = g.add_edge(nodes[uid], nodes[vid], e.overlap)
        return GraphView(g, nodes, edges)

    # ---- dense device view ----
    def tensors(self) -> GraphTensors:
        ids = list(self.nodes.keys())
        index = {vid: i for i, vid in enumerate(ids)}
        dp = np.array([self.nodes[i].dp for i in ids], dtype=np.float32)
        seq_len = np.array([len(self.nodes[i].seq) for i in ids],
                           dtype=np.int32)
        e_items = [((u, w), e) for (u, w), e in self.edges.items()
                   if u in index and w in index]
        edge_src = np.array([index[u] for (u, _), _ in e_items],
                            dtype=np.int32)
        edge_dst = np.array([index[w] for (_, w), _ in e_items],
                            dtype=np.int32)
        edge_overlap = np.array([e.overlap for _, e in e_items],
                                dtype=np.int32)
        edge_flow = np.array([e.flow for _, e in e_items], dtype=np.float32)
        return GraphTensors(ids, dp, seq_len, edge_src, edge_dst,
                            edge_overlap, edge_flow)

    def num_nodes(self) -> int:
        return len(self.nodes)

    def num_edges(self) -> int:
        return len(self.edges)


def new_view() -> GraphView:
    return GraphView(AssemblyGraph(), {}, {})
