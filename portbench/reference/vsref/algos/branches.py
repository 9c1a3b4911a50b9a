"""Non-trivial branch detection and coverage re-inflation.

Parity: VStrains' utils/VStrains_Utilities.py:162-208.
"""

from __future__ import annotations

import logging
from typing import Dict

from portbench.reference.vsref.core.graph import BLACK, GraphView, Vertex

_LOG = logging.getLogger(__name__)


def is_non_trivial(node: Vertex) -> bool:
    """N-M branch with both sides exceeding their intersection
    (Utilities:162-172)."""
    us = [e.source.vid for e in node.in_edges() if e.color == BLACK]
    ws = [e.target.vid for e in node.out_edges() if e.color == BLACK]
    intersects = set(us).intersection(set(ws))
    return (len(us) > max(len(intersects), 1)
            and len(ws) > max(len(intersects), 1))


def get_non_trivial_branches(view: GraphView) -> Dict[str, Vertex]:
    """All live non-trivial branch nodes, in node-dict order
    (Utilities:175-180)."""
    return {no: node for no, node in view.nodes.items()
            if is_non_trivial(node)}


def increment_nt_branch_coverage(view: GraphView,
                                 logger: logging.Logger = None) -> None:
    """Raise each NT branch's depth to the max of its in/out sums
    (Utilities:183-208): neighbor-depth sums for simple branches, edge-flow
    sums otherwise."""
    logger = logger or _LOG
    nt_branches = get_non_trivial_branches(view)
    for no, node in nt_branches.items():
        prev_dp = node.dp
        if (sum(x.out_degree() for x in node.in_neighbors())
                == node.in_degree()
                and sum(y.in_degree() for y in node.out_neighbors())
                == node.out_degree()):
            sum_in_dp = sum(n.dp for n in node.in_neighbors())
            sum_out_dp = sum(n.dp for n in node.out_neighbors())
            node.dp = max([prev_dp, sum_in_dp, sum_out_dp])
            logger.debug("Simple NT Branch:%s, cov: %s -> %s",
                         no, prev_dp, node.dp)
        else:
            sum_in_flow = sum(e.flow for e in node.in_edges())
            sum_out_flow = sum(e.flow for e in node.out_edges())
            node.dp = max([prev_dp, sum_in_flow, sum_out_flow])
            logger.debug("Non-Simple NT Branch:%s, cov: %s -> %s",
                         no, prev_dp, node.dp)
