"""GFA 1.0 parsing and writing (host-side, no gfapy dependency).

Covers the reference's gfapy-based I/O surface:
  * raw SPAdes GFA parse with dp/LN/KC coverage tags
    (VStrains' utils/VStrains_IO.py:27-134),
  * canonized single-orientation GFA write
    (VStrains' utils/VStrains_IO.py:337-372),
  * canonized GFA reload (VStrains' utils/VStrains_IO.py:298-334).

File I/O is host work by design; sequences feed the device as code tensors
via core/seq.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Tuple

from portbench.reference.vsref.core.graph import BLACK, AssemblyGraph, GraphView


class GfaFormatError(Exception):
    pass


@dataclass
class Segment:
    name: str
    seq: str
    dp: float


@dataclass
class Link:
    src: str
    src_ori: str
    dst: str
    dst_ori: str
    overlap: int


def parse_gfa(path: str, require_cov: bool = True
              ) -> Tuple[List[Segment], List[Link]]:
    """Parse S/L lines. Coverage from dp/DP tag, else KC/LN ratio
    (reference tag logic: VStrains_IO.py:56-77)."""
    segments: List[Segment] = []
    links: List[Link] = []
    with open(path, "r") as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if not fields:
                continue
            if fields[0] == "S":
                if len(fields) < 3:
                    raise GfaFormatError(f"bad S line in {path}: {line!r}")
                name, seq = fields[1], fields[2]
                tags = fields[3:]
                dp_float = 0.0
                ln = 0
                kc = 0
                for tag in tags:
                    if tag.startswith("dp") or tag.startswith("DP"):
                        dp_float = float(tag.split(":")[2])
                        break
                    if tag.startswith("ln") or tag.startswith("LN"):
                        ln = int(tag.split(":")[2])
                    if tag.startswith("kc") or tag.startswith("KC"):
                        kc = int(tag.split(":")[2])
                    if ln != 0 and kc != 0:
                        break
                if require_cov and dp_float == 0 and (ln == 0 or kc == 0):
                    raise GfaFormatError(
                        f"file: {path}, illegal graph format: segment "
                        f"{name!r} lacks dp/DP or KC+LN coverage tags")
                if dp_float == 0 and ln != 0:
                    dp_float = kc / ln
                segments.append(Segment(name, seq, dp_float))
            elif fields[0] == "L":
                if len(fields) < 6:
                    raise GfaFormatError(f"bad L line in {path}: {line!r}")
                src, src_ori, dst, dst_ori = fields[1:5]
                ov_tags = [t for t in fields[5:]
                           if t.endswith("m") or t.endswith("M")]
                if not ov_tags or not ov_tags[0].endswith("M"):
                    raise GfaFormatError(
                        f"L line without cigar overlap in {path}: {line!r}")
                links.append(Link(src, src_ori, dst, dst_ori,
                                  int(ov_tags[0][:-1])))
    return segments, links


def write_gfa(view: GraphView, path: str,
              logger: logging.Logger = None) -> None:
    """Write the canonized (all-'+') graph; black elements only.

    Format parity with VStrains_IO.py:337-372 (S: DP:f: tag; L: '+' both
    orientations, '<overlap>M').
    """
    with open(path, "w") as gfa:
        for v in view.nodes.values():
            if v.color == BLACK:
                gfa.write(f"S\t{v.vid}\t{v.seq}\tDP:f:{v.dp}\n")
        for (u, w), e in view.edges.items():
            nu = view.nodes.get(u)
            nw = view.nodes.get(w)
            if nu is None or nw is None:
                continue
            if nu.color != BLACK or nw.color != BLACK:
                continue
            if e.color != BLACK:
                continue
            gfa.write(f"L\t{u}\t+\t{w}\t+\t{e.overlap}M\n")
    if logger:
        logger.info(path + " is stored..")


def store_reinit_graph(view: GraphView, path: str = None,
                       logger: logging.Logger = None) -> GraphView:
    """Checkpoint + compact + re-derive edge flows.

    Replaces the reference's write-GFA-then-reload idiom
    (VStrains_IO.py:630-642): compaction happens in memory
    (GraphView.compact matches the write-filter + reload ordering exactly);
    the GFA file, when a path is given, is written as a stage checkpoint for
    inspectability/resume, not re-read.
    """
    from portbench.reference.vsref.graph_ops import assign_edge_flow

    if path is not None:
        write_gfa(view, path, logger)
    new_view = view.compact()
    assign_edge_flow(new_view)
    return new_view


def load_flipped_gfa(path: str, logger: logging.Logger = None) -> GraphView:
    """Reload a canonized GFA written by write_gfa
    (parity: VStrains_IO.py:298-334)."""
    g = AssemblyGraph()
    nodes = {}
    edges = {}
    with open(path, "r") as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if not fields or not fields[0]:
                continue
            if fields[0] == "S":
                _, seg_no, seg, dp = fields
                nodes[seg_no] = g.add_vertex(seg_no, seg,
                                             float(dp.split(":")[2]))
            elif fields[0] == "L":
                _, u, ou, w, ow, ov = fields
                assert ov[-1] == "M" and ou == ow
                edges[(u, w)] = g.add_edge(nodes[u], nodes[w],
                                           overlap=int(ov[:-1]))
    return GraphView(g, nodes, edges)
