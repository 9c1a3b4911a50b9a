"""Graph-state invariant checks (the framework's sanitizer).

The reference's only runtime guard is numpy.seterr(all="raise")
(reference vstrains:25) plus scattered asserts. Host-graph mutation bugs
(the analogue of data races in this single-threaded design) corrupt the
dict/adjacency invariants silently, so dev mode validates them at every
stage boundary:

  * every live-dict node is black and registered under its own vid;
  * every live-dict edge is black, its endpoints are live, and the edge
    is present in both endpoints' adjacency lists;
  * no duplicate (src, dst) live edges (the reference rejects parallel
    edges at parse time, VStrains_IO.py:110-115);
  * every dense GraphTensors index maps back to the same node.

`enable_numeric_guards()` mirrors the numpy fail-fast setting.
"""

from __future__ import annotations

import logging

import numpy

from vstrains_tpu_torch.core.graph import BLACK, GraphView

_LOG = logging.getLogger(__name__)


class GraphInvariantError(AssertionError):
    pass


def validate_view(view: GraphView, where: str = "") -> None:
    """Raise GraphInvariantError on any violated invariant."""
    def fail(msg):
        raise GraphInvariantError(f"[{where}] {msg}")

    for vid, node in view.nodes.items():
        if node.vid != vid:
            fail(f"node dict key {vid!r} != vertex id {node.vid!r}")
        if node.color != BLACK:
            fail(f"live node {vid!r} is {node.color}")

    seen = set()
    for (u, w), e in view.edges.items():
        if (u, w) in seen:
            fail(f"duplicate live edge {(u, w)}")
        seen.add((u, w))
        if e.color != BLACK:
            fail(f"live edge {(u, w)} is {e.color}")
        if e.source.vid != u or e.target.vid != w:
            fail(f"edge key {(u, w)} != endpoints "
                 f"({e.source.vid}, {e.target.vid})")
        if u not in view.nodes or w not in view.nodes:
            fail(f"live edge {(u, w)} touches dead node")
        if e not in e.source.out_e:
            fail(f"edge {(u, w)} missing from source adjacency")
        if e not in e.target.in_e:
            fail(f"edge {(u, w)} missing from target adjacency")

    t = view.tensors()
    ids = list(view.nodes.keys())
    if t.ids != ids:
        fail("GraphTensors id order != node dict order")
    for i, vid in enumerate(ids):
        if float(t.dp[i]) != numpy.float32(view.nodes[vid].dp):
            fail(f"GraphTensors dp mismatch at {vid!r}")


def enable_numeric_guards() -> None:
    """Fail fast on FP anomalies (reference parity: numpy.seterr)."""
    numpy.seterr(all="raise")
