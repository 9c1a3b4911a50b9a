"""Cycle / reachability toolbox on the host graph.

Parity: VStrains' utils/VStrains_Utilities.py:1073-1303
(add_global_source_sink, graph_is_DAG, graph_is_DAG_simp, retrieve_cycle,
cyclic_to_dag, reachable). A device frontier-iteration DAG check for dense
GraphTensors lives in ops/graph_ops.graph_is_dag_device.

`elementary_circuits` (Johnson's algorithm) replaces graph-tool's
all_circuits used by concat_overlap_contig (Utilities:672).
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List, Sequence, Tuple

from portbench.reference.vsref.core.graph import BLACK, GraphView, Vertex

_LOG = logging.getLogger(__name__)


def graph_is_DAG(view: GraphView) -> bool:
    """Color-aware acyclicity over live nodes (Utilities:1158-1202),
    iterative DFS."""
    visited: Dict[Vertex, bool] = {}
    for node in view.nodes.values():
        visited[node] = node.color != BLACK

    in_stack: Dict[Vertex, bool] = {v: False for v in visited}

    for root in view.nodes.values():
        if visited[root]:
            continue
        # iterative DFS with recursion-stack tracking
        stack: List[Tuple[Vertex, int]] = [(root, 0)]
        visited[root] = True
        in_stack[root] = True
        while stack:
            v, ei = stack[-1]
            out_edges = [e for e in v.out_e if e.color == BLACK]
            if ei < len(out_edges):
                stack[-1] = (v, ei + 1)
                nb = out_edges[ei].target
                if nb not in visited:
                    continue
                if in_stack.get(nb, False):
                    return False
                if not visited[nb]:
                    visited[nb] = True
                    in_stack[nb] = True
                    stack.append((nb, 0))
            else:
                in_stack[v] = False
                stack.pop()
    return True


def graph_is_DAG_simp(nodes: Sequence[Vertex]) -> bool:
    """Acyclicity ignoring colors (Utilities:1117-1155)."""
    visited = {v: False for v in nodes}
    in_stack = {v: False for v in nodes}
    for root in nodes:
        if visited[root]:
            continue
        stack = [(root, 0)]
        visited[root] = True
        in_stack[root] = True
        while stack:
            v, ei = stack[-1]
            outs = [e.target for e in v.out_e]
            if ei < len(outs):
                stack[-1] = (v, ei + 1)
                nb = outs[ei]
                if nb not in visited:
                    continue
                if in_stack[nb]:
                    return False
                if not visited[nb]:
                    visited[nb] = True
                    in_stack[nb] = True
                    stack.append((nb, 0))
            else:
                in_stack[v] = False
                stack.pop()
    return True


def retrieve_cycle(view: GraphView, n: int = 1) -> List[List[Vertex]]:
    """Return up to n cycles (lists of vertices), or None
    (Utilities:1205-1239)."""
    cycles: List[List[Vertex]] = []
    sys.setrecursionlimit(max(sys.getrecursionlimit(),
                              10 * view.graph.num_vertices() + 1000))
    visited = {v: "unvisited" for v in view.graph.vertices()}

    def process(stack: List[Vertex], n: int) -> int:
        for out_e in stack[-1].out_e:
            if out_e.color != BLACK:
                continue
            if n == 0:
                return n
            nxt = out_e.target
            if visited[nxt] == "instack":
                n -= 1
                cycles.append(stack[stack.index(nxt):])
            elif visited[nxt] == "unvisited":
                visited[nxt] = "instack"
                stack.append(nxt)
                n = process(stack, n)
        visited[stack[-1]] = "done"
        stack.pop()
        return n

    for v in view.graph.vertices():
        if visited[v] == "unvisited":
            stack = [v]
            visited[v] = "instack"
            n = process(stack, n)
            if n == 0:
                break
    return cycles if len(cycles) > 0 else None


def cyclic_to_dag(view: GraphView, logger: logging.Logger = None):
    """Break cycles by deleting the lower-coverage edge around each cycle's
    max-depth node until acyclic (Utilities:1242-1278)."""
    logger = logger or _LOG
    removed_edges = []

    def remove_edge(fst: Vertex, snd: Vertex):
        logger.debug("removing edge: %s -> %s to reduce a cycle",
                     fst.vid, snd.vid)
        e = view.graph.edge(fst, snd)
        e.color = "gray"
        removed_edges.append((fst.vid, snd.vid, e.overlap))

    logger.debug("breaking cycles to obtain a DAG..")
    if graph_is_DAG(view):
        logger.debug("already acyclic; nothing to do")
    else:
        while not graph_is_DAG(view):
            cycle = retrieve_cycle(view)[0]
            max_node = max(cycle, key=lambda v: v.dp)
            prev_node = cycle[(cycle.index(max_node) - 1) % len(cycle)]
            next_node = cycle[(cycle.index(max_node) + 1) % len(cycle)]
            if prev_node.dp < next_node.dp:
                remove_edge(prev_node, max_node)
            else:
                remove_edge(max_node, next_node)
    for uid, vid, _ in removed_edges:
        e = view.edges.pop((uid, vid))
        view.graph.remove_edge(e)
    logger.debug("done")
    return removed_edges


def reachable(view: GraphView, src: Vertex, tgt: Vertex) -> bool:
    """Can src reach tgt (tgt twice if src==tgt)? (Utilities:1281-1303)."""
    visited = {v: False for v in view.graph.vertices()}
    count_down = 1 if src is not tgt else 2
    queue = [src]
    while queue:
        curr = queue.pop()
        visited[curr] = True
        if curr is tgt:
            count_down -= 1
            if count_down == 0:
                return True
            visited[curr] = False
        for oute in curr.out_e:
            out = oute.target
            if not visited[out]:
                queue.append(out)
    return False


def add_global_source_sink(view: GraphView):
    """Attach a global source/sink spanning all current sources/sinks
    (Utilities:1073-1109)."""
    src_nodes = [n for n in view.graph.vertices() if n.in_degree() == 0]
    tgt_nodes = [n for n in view.graph.vertices() if n.out_degree() == 0]

    global_src = view.add_vertex("global_src", 0.0, "")
    for src in src_nodes:
        e = view.add_edge(global_src, src, overlap=0, flow=src.dp)
        global_src.dp += e.flow

    global_sink = view.add_vertex("global_sink", 0.0, "")
    for tgt in tgt_nodes:
        e = view.add_edge(tgt, global_sink, overlap=0, flow=tgt.dp)
        global_sink.dp += e.flow
    return global_src, global_sink


def elementary_circuits(nodes: List[str],
                        out_adj: Dict[str, List[str]]
                        ) -> List[List[str]]:
    """Johnson's elementary-circuit enumeration on a small id-keyed digraph
    (replacement for graph-tool all_circuits, Utilities:672)."""
    index = {n: i for i, n in enumerate(nodes)}
    circuits: List[List[str]] = []

    for start_i, start in enumerate(nodes):
        blocked = {n: False for n in nodes}
        b_map: Dict[str, set] = {n: set() for n in nodes}
        stack: List[str] = []

        def unblock(u: str):
            blocked[u] = False
            for w in list(b_map[u]):
                b_map[u].discard(w)
                if blocked[w]:
                    unblock(w)

        def circuit(v: str) -> bool:
            found = False
            stack.append(v)
            blocked[v] = True
            for w in out_adj.get(v, []):
                if index[w] < start_i:
                    continue
                if w == start:
                    circuits.append(list(stack))
                    found = True
                elif not blocked[w]:
                    if circuit(w):
                        found = True
            if found:
                unblock(v)
            else:
                for w in out_adj.get(v, []):
                    if index[w] >= start_i:
                        b_map[w].add(v)
            stack.pop()
            return found

        circuit(start)
    return circuits
