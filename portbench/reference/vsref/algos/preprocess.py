"""Graph preprocessing: reindexing and low-coverage simplification.

Parity: VStrains' utils/VStrains_Preprocess.py:13-34 (reindexing),
73-123 (graph_simplification). The coverage threshold itself comes from
ops/graph_ops.threshold_estimation.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

from portbench.reference.vsref.algos.contig_ops import contig_map_node
from portbench.reference.vsref.core.graph import BLACK, GraphView

_LOG = logging.getLogger(__name__)


def reindexing(view: GraphView) -> Tuple[GraphView, Dict[str, str]]:
    """Rename live nodes to dense integer-string ids '0'..'N-1'; returns the
    (new view over the same graph, orig->idx mapping)."""
    idx_mapping: Dict[str, str] = {}
    idx_node_dict = {}
    idx_edge_dict = {}
    idx = 0
    for no, node in view.nodes.items():
        if node.color == BLACK:
            idx_mapping[no] = str(idx)
            node.vid = str(idx)
            idx_node_dict[str(idx)] = node
            idx += 1
    for (u, v), e in view.edges.items():
        if (e.color == BLACK and e.source.color == BLACK
                and e.target.color == BLACK):
            idx_edge_dict[(idx_mapping[u], idx_mapping[v])] = e
    return GraphView(view.graph, idx_node_dict, idx_edge_dict), idx_mapping


def graph_simplification(view: GraphView, contig_dict,
                         min_cov: float, logger: logging.Logger = None
                         ) -> None:
    """Drop every node with dp <= min_cov (and its edges) unless protected
    by a contig (VStrains_Preprocess.py:73-123)."""
    logger = logger or _LOG
    logger.info("pruning low-coverage nodes")
    logger.debug("Total nodes: %d Total edges: %d",
                 len(view.nodes), len(view.edges))
    node_to_contig_dict: Dict[str, set] = {}
    edge_to_contig_dict: Dict[tuple, set] = {}
    if contig_dict is not None:
        node_to_contig_dict, edge_to_contig_dict = contig_map_node(
            contig_dict)
    for id_, node in list(view.nodes.items()):
        if node.dp <= min_cov:
            if id_ in node_to_contig_dict:
                continue
            view.remove_vertex(id_)
            for e in list(dict.fromkeys(node.all_edges())):
                uid = e.source.vid
                vid = e.target.vid
                if (uid, vid) in edge_to_contig_dict:
                    continue
                if (uid, vid) in view.edges:
                    view.remove_edge(uid, vid)
    logger.debug("Remain nodes: %d Total edges: %d",
                 len(view.nodes), len(view.edges))
    logger.info("done")
