"""Contig-based path extension: greedy bidirectional walks guided by
contig / PE-link / coverage evidence, with coverage subtraction.

Parity: VStrains' utils/VStrains_Extension.py
  - best_matching       (:10-111)
  - contig_extension    (:115-342)
  - final_extension     (:345-418)
  - get_bubble_nodes    (:421-426)
  - reduce_graph        (:429-456)  -> reduce_graph_cov here
  - reduce_id_simple / reduce_Anode (:458-481)
  - path_extension      (:484-899)

Host orchestration: each greedy step compares a handful of scalars; the
sequential extract-subtract loop is inherently serial (each strain's
coverage subtraction gates the next choice).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy

from portbench.reference.vsref.algos.branches import get_non_trivial_branches
from portbench.reference.vsref.algos.contig_ops import contig_dict_remapping
from portbench.reference.vsref.algos.decomposition import global_trivial_split
from portbench.reference.vsref.algos.pathmath import path_len, path_to_seq
from portbench.reference.vsref.core.gfa import store_reinit_graph
from portbench.reference.vsref.core.graph import BLACK, GraphView, Vertex

_LOG = logging.getLogger(__name__)


def best_matching(view: GraphView, contig_dict: dict, pe_info: dict,
                  logger: logging.Logger = None) -> dict:
    """Per-branch kept-links on the final split graph: contig-supported and
    self links first, then any positive PE link (Extension:10-111)."""
    logger = logger or _LOG
    from portbench.reference.vsref.algos.contig_ops import contig_map_node

    full_link = {}
    non_trivial_branches = get_non_trivial_branches(view)
    node_to_contig_dict, _ = contig_map_node(contig_dict)
    for no, node in non_trivial_branches.items():
        us = [src.vid for src in node.in_neighbors()]
        ws = [tgt.vid for tgt in node.out_neighbors()]
        logger.debug("---------------------------------------------")
        logger.debug("resolving non-trivial branch %s (in-degree %s, "
                     "out-degree %s)", no, len(us), len(ws))
        support_contigs = sorted(node_to_contig_dict.get(no, []))
        con_info = {}
        for cno in support_contigs:
            [contig, clen, ccov] = contig_dict[cno]
            loc = contig.index(no)
            if 0 < loc < len(contig) - 1:
                con_info.setdefault((contig[loc - 1], contig[loc + 1]),
                                    []).append((cno, clen, ccov))
        accepted_links = {}
        cand_links = []
        in_taken = dict.fromkeys(us, 0)
        out_taken = dict.fromkeys(ws, 0)
        for uid in us:
            for wid in ws:
                curr_pe = pe_info[(min(uid, wid), max(uid, wid))]
                logger.debug("%s -> %s PE: %s", uid, wid, curr_pe)
                accept = False
                if (uid, wid) in con_info:
                    accept = True
                if uid == wid:
                    accept = True
                if accept:
                    in_taken[uid] += 1
                    out_taken[wid] += 1
                    accepted_links[(uid, wid)] = curr_pe
                else:
                    cand_links.append((uid, wid, curr_pe))
        ranked_cands = sorted(cand_links, key=lambda x: x[2], reverse=True)
        for uid, wid, pe in ranked_cands:
            if pe > 0:
                logger.debug("candidate link %s->%s (pe=%s)",
                             uid, wid, pe)
                in_taken[uid] += 1
                out_taken[wid] += 1
                accepted_links[(uid, wid)] = pe
        full_link[no] = accepted_links
    return full_link


def get_bubble_nodes(view: GraphView, contig: List[str]) -> List[Vertex]:
    """Degree-(1,1) nodes of a contig (Extension:421-426)."""
    return [view.nodes[no] for no in contig
            if view.nodes[no].in_degree() == 1
            and view.nodes[no].out_degree() == 1]


def reduce_graph_cov(view: GraphView, usages: dict, full_link: dict,
                     path: List[Vertex], pcov: float, threshold: float,
                     logger: logging.Logger = None) -> None:
    """Subtract an extracted strain's coverage; gray out depleted nodes and
    drop links touching them (Extension:429-456)."""
    logger = logger or _LOG
    del_nodes_ids = []
    for node in path:
        usages[node.vid] += 1
        node.dp -= pcov
        if node.dp <= threshold:
            del_nodes_ids.append(node.vid)
            node.color = "gray"
            usages.pop(node.vid)
    logger.debug("invalid nodes: %s", del_nodes_ids)
    for links in full_link.values():
        for uid, wid in list(links.keys()):
            if (view.nodes[uid].color != BLACK
                    or view.nodes[wid].color != BLACK):
                links.pop((uid, wid))
                logger.debug("[D]%s, %s", uid, wid)


def reduce_id_simple(id_l: List[str]) -> List[str]:
    """Strip '&' merges and '*' split suffixes (Extension:458-466)."""
    ids = []
    for id_ in id_l:
        for iid in id_.split("&"):
            if iid.find("*") != -1:
                ids.append(iid[: iid.find("*")])
            else:
                ids.append(iid)
    return ids


def reduce_Anode(id_: str, sno2ids: dict) -> List[str]:
    """Recursively expand inserted path-node ids 'A<rid>' back to member ids
    (Extension:469-481)."""
    ids = [id_]
    while any(iid.startswith("A") for iid in ids):
        len_ids = len(ids)
        for i in range(len_ids):
            if ids[i].startswith("A"):
                id_v = ids.pop(i).split("*")[0]
                j = i
                for subid in sno2ids[id_v]:
                    ids.insert(j, subid)
                    j += 1
                break
    return ids


def contig_extension(view: GraphView, contig: List[str], ccov: float,
                     full_link: dict, threshold: float,
                     logger: logging.Logger = None) -> List[Vertex]:
    """Greedy bidirectional walk from a contig: unique edge, else unique
    link (coverage-gated), else mutual-best coverage match with ambiguity
    delta test, else top-vs-second 'last bit' test (Extension:115-342)."""
    logger = logger or _LOG
    visited = dict.fromkeys(view.nodes.keys(), False)
    for no in contig[1:-1]:
        visited[no] = True
    final_path: List[Vertex] = [view.nodes[no] for no in contig][1:-1]

    curr = view.nodes[contig[-1]]
    logger.debug("forward walk (contig tail -> sink)")
    while curr is not None and not visited[curr.vid]:
        visited[curr.vid] = True
        final_path.append(curr)
        out_branches = list(curr.out_neighbors())
        if len(out_branches) == 0:
            curr = None
            logger.debug("dead end, walk stops")
        elif len(out_branches) == 1:
            curr = out_branches[0]
            logger.debug("unique edge, walking on to %s", curr.vid)
        else:
            f_assigned = False
            if curr.vid in full_link and len(final_path) > 1:
                logger.debug("at a linked branch node")
                curr_links = [view.nodes[wid]
                              for (uid, wid) in full_link[curr.vid].keys()
                              if uid == final_path[-2].vid]
                if len(curr_links) == 1:
                    if curr_links[0].dp - ccov <= -2 * threshold:
                        curr = None
                        logger.debug("%s single link < 2delta, use coverage",
                                     curr_links[0].vid)
                    else:
                        curr = curr_links[0]
                        logger.debug("single link next: %s", curr.vid)
                elif len(curr_links) > 1:
                    logger.debug("coverage tie within the ambiguity bound; walk ends")
                    curr = None
                else:
                    logger.debug("no PE link at this branch; falling back to coverage")
                    f_assigned = True
            else:
                curr = None
                logger.debug("branch absent from link table (or single-node path)")
            if f_assigned:
                in_branches = list(curr.in_neighbors())
                if len(final_path) > 1 and len(in_branches) > 0:
                    curru = final_path[-2]
                    opt_ws = sorted(out_branches,
                                    key=lambda ww: abs(curru.dp - ww.dp))
                    bestw = opt_ws[0]
                    opt_us = sorted(in_branches,
                                    key=lambda uu: abs(bestw.dp - uu.dp))
                    if opt_us[0] is curru:
                        delta = max(2 * abs(curru.dp - bestw.dp), threshold)
                        if (len(opt_us) > 1
                                and abs(opt_us[1].dp - bestw.dp) <= delta):
                            logger.debug("ambiguous best matching, stop")
                            continue
                        if (len(opt_ws) > 1
                                and abs(curru.dp - opt_ws[1].dp) <= delta):
                            logger.debug("ambiguous best matching, stop")
                            continue
                        logger.debug("best matching")
                        curr = bestw
                    else:
                        logger.debug("mutual-best check failed, no coverage pick")
                        curr = None
                else:
                    curr = None
                    logger.debug("no link and branching topology - walk ends here")
            if curr is None:
                single_bests = sorted(
                    [(onode, onode.dp) for onode in out_branches],
                    key=lambda tp: tp[1], reverse=True)
                logger.debug("top-vs-runner-up test: 1st: %s, 2nd: %s, delta: %s, "
                             "cov: %s",
                             (single_bests[0][0].vid, single_bests[0][1]),
                             (single_bests[1][0].vid, single_bests[1][1]),
                             threshold, ccov)
                if (single_bests[0][1] - ccov > -threshold
                        and single_bests[1][1] - ccov <= -threshold):
                    logger.debug("top-vs-runner-up coverage test passed")
                    curr = single_bests[0][0]
                else:
                    logger.debug("top-vs-runner-up test failed, walk stops")

    unode = view.nodes[contig[0]]
    if len(contig) == 1 and final_path[-1] not in unode.in_neighbors():
        visited[contig[0]] = False
        final_path.pop(0)
    curr = unode
    logger.debug("backward walk (source -> contig head)")
    while curr is not None and not visited[curr.vid]:
        visited[curr.vid] = True
        final_path.insert(0, curr)
        in_branches = list(curr.in_neighbors())
        if len(in_branches) == 0:
            curr = None
            logger.debug("dead end, walk stops")
        elif len(in_branches) == 1:
            curr = in_branches[0]
            logger.debug("unique edge, walking on to %s", curr.vid)
        else:
            f_assigned = False
            if curr.vid in full_link and len(final_path) > 1:
                logger.debug("at a linked branch node")
                curr_links = [view.nodes[uid]
                              for (uid, wid) in full_link[curr.vid].keys()
                              if wid == final_path[1].vid]
                if len(curr_links) == 1:
                    if curr_links[0].dp - ccov <= -2 * threshold:
                        curr = None
                        logger.debug("%s single link < 2delta, use coverage",
                                     curr_links[0].vid)
                    else:
                        curr = curr_links[0]
                        logger.debug("prev: %s", curr.vid)
                elif len(curr_links) > 1:
                    logger.debug("coverage tie within the ambiguity bound; walk ends")
                    curr = None
                else:
                    logger.debug("no PE link at this branch; falling back to coverage")
                    f_assigned = True
            else:
                curr = None
                logger.debug("branch absent from link table (or single-node path)")
            if f_assigned:
                out_branches = list(curr.out_neighbors())
                if len(final_path) > 1 and len(out_branches) > 0:
                    currw = final_path[1]
                    opt_us = sorted(in_branches,
                                    key=lambda uu: abs(currw.dp - uu.dp))
                    bestu = opt_us[0]
                    opt_ws = sorted(out_branches,
                                    key=lambda ww: abs(bestu.dp - ww.dp))
                    if opt_ws[0] is currw:
                        delta = max(2 * abs(currw.dp - bestu.dp), threshold)
                        if (len(opt_us) > 1
                                and abs(opt_us[1].dp - currw.dp) <= delta):
                            logger.debug("ambiguous best matching, stop")
                            continue
                        if (len(opt_ws) > 1
                                and abs(bestu.dp - opt_ws[1].dp) <= delta):
                            logger.debug("ambiguous best matching, stop")
                            continue
                        logger.debug("best matching")
                        curr = bestu
                    else:
                        logger.debug("mutual-best check failed, no coverage pick")
                        curr = None
                else:
                    logger.debug("no link and branching topology - walk ends here")
                    curr = None
            if curr is None:
                single_bests = sorted(
                    [(inode, inode.dp) for inode in in_branches],
                    key=lambda tp: tp[1], reverse=True)
                logger.debug("top-vs-runner-up test: 1st: %s, 2nd: %s, delta: %s, "
                             "cov: %s",
                             (single_bests[0][0].vid, single_bests[0][1]),
                             (single_bests[1][0].vid, single_bests[1][1]),
                             threshold, ccov)
                if (single_bests[0][1] - ccov > -threshold
                        and single_bests[1][1] - ccov <= -threshold):
                    logger.debug("top-vs-runner-up coverage test passed")
                    curr = single_bests[0][0]
                else:
                    logger.debug("top-vs-runner-up test failed, walk stops")
    return final_path


def final_extension(view: GraphView, contig: List[str], full_link: dict,
                    logger: logging.Logger = None) -> List[Vertex]:
    """Link-only bidirectional walk used for leftover free nodes
    (Extension:345-418)."""
    logger = logger or _LOG
    visited = dict.fromkeys(view.nodes.keys(), False)
    for no in contig[1:-1]:
        visited[no] = True
    curr = view.nodes[contig[-1]]
    final_path: List[Vertex] = [view.nodes[no] for no in contig][1:-1]
    logger.debug("forward walk (contig tail -> sink)")
    while curr is not None and not visited[curr.vid]:
        visited[curr.vid] = True
        final_path.append(curr)
        out_branches = list(curr.out_neighbors())
        if len(out_branches) == 0:
            curr = None
        elif len(out_branches) == 1:
            curr = out_branches[0]
        else:
            if curr.vid in full_link and len(final_path) > 1:
                curr_links = [view.nodes[wid]
                              for (uid, wid) in full_link[curr.vid].keys()
                              if uid == final_path[-2].vid]
                if len(curr_links) == 1:
                    curr = curr_links[0]
                else:
                    curr = None
            else:
                curr = None

    unode = view.nodes[contig[0]]
    if len(contig) == 1 and final_path[-1] not in unode.in_neighbors():
        visited[contig[0]] = False
        final_path.pop(0)
    curr = unode
    logger.debug("backward walk (source -> contig head)")
    while curr is not None and not visited[curr.vid]:
        visited[curr.vid] = True
        final_path.insert(0, curr)
        in_branches = list(curr.in_neighbors())
        if len(in_branches) == 0:
            curr = None
        elif len(in_branches) == 1:
            curr = in_branches[0]
        else:
            if curr.vid in full_link and len(final_path) > 1:
                curr_links = [view.nodes[uid]
                              for (uid, wid) in full_link[curr.vid].keys()
                              if wid == final_path[1].vid]
                if len(curr_links) == 1:
                    curr = curr_links[0]
                else:
                    curr = None
            else:
                curr = None
    return final_path


def path_extension(view: GraphView, contig_dict: dict, full_link: dict,
                   pe_info: dict, threshold: float, temp_dir: str = None,
                   logger: logging.Logger = None) -> Tuple[dict, dict, GraphView]:
    """Core extraction loop (Extension:484-899): repeatedly pop the longest
    contig, extend it into a maximal strain, subtract its coverage, and
    re-insert still-connected paths as merged 'A<rid>' nodes; then extract
    leftover long free nodes via link-only walks."""
    logger = logger or _LOG
    logger.debug("-------------------------PATH Extension, delta: %s",
                 threshold)
    usages = dict.fromkeys(view.nodes.keys(), 0)
    strain_dict: Dict[str, list] = {}
    rid = 1
    sno2ids: Dict[str, list] = {}

    def ckpt(name):
        return f"{temp_dir}/gfa/{name}" if temp_dir else None

    while len(contig_dict) > 0:
        prev_ids = list(view.nodes.keys())
        _tsc, id_mapping = global_trivial_split(view, logger)
        view = store_reinit_graph(view, ckpt(f"graph_S{rid}.gfa"), logger)
        red_id_mapping = contig_dict_remapping(view, contig_dict,
                                               id_mapping, prev_ids, logger)
        # remap links (Extension:525-546)
        for no in list(full_link.keys()):
            if no not in view.nodes:
                full_link.pop(no)
            else:
                accepted_links = full_link.pop(no)
                node = view.nodes[no]
                for (uid, wid), pe in list(accepted_links.items()):
                    accepted_links.pop((uid, wid))
                    if (len(red_id_mapping[uid]) == 1
                            or len(red_id_mapping[wid]) == 1):
                        for uuid in sorted(red_id_mapping[uid]):
                            for wwid in sorted(red_id_mapping[wid]):
                                if ((uuid, wwid) not in accepted_links
                                        and view.nodes[uuid]
                                        in node.in_neighbors()
                                        and view.nodes[wwid]
                                        in node.out_neighbors()):
                                    accepted_links[(uuid, wwid)] = pe
                full_link[no] = accepted_links
        # remap usages
        for no, u in list(usages.items()):
            usages.pop(no)
            for new_no in red_id_mapping[no]:
                usages[new_no] = u

        # pop the longest remaining contig
        (longest_cno, [contig, clen, ccov]) = max(
            contig_dict.items(), key=lambda tp: tp[1][1])
        contig_dict.pop(longest_cno)
        if all(usages[cn] > 0 for cn in contig):
            logger.debug("contig nodes already consumed, dropped: %s %s", longest_cno,
                         contig)
            continue
        if any(view.nodes[no].color == "gray" for no in contig):
            logger.debug("a path node fell below the coverage floor, contig skipped: %s %s",
                         longest_cno, contig)
            continue

        cbubbles = get_bubble_nodes(view, contig)
        bbl_cov = (float(numpy.median([n.dp for n in cbubbles]))
                   if len(cbubbles) != 0 else ccov)
        logger.debug("-----> Current extending contig %s: org ccov: %s, "
                     "use min %s", longest_cno, ccov, min(ccov, bbl_cov))

        path = contig_extension(view, contig, min(ccov, bbl_cov),
                                full_link, threshold, logger)
        pno = "A" + str(rid)
        plen = path_len(view, path)
        path_ids = [n.vid for n in path]
        sno2ids[pno] = []
        for pid in path_ids:
            if pid in sno2ids:
                sno2ids[pno].extend(sno2ids[pid])
            else:
                sno2ids[pno].append(pid)
        pbubbles = get_bubble_nodes(view, path_ids)
        bbl_pcov = (float(numpy.median([n.dp for n in pbubbles]))
                    if len(pbubbles) != 0 else ccov)
        pcov = min([ccov, bbl_pcov, bbl_cov])
        logger.debug("---*extended from contig %s: %s", longest_cno,
                     path_ids)
        logger.debug("name: %s, plen: %s, pcov: %s, bubble cov: %s",
                     pno, plen, pcov, bbl_pcov)
        strain_dict[pno] = [sno2ids[pno], plen, pcov]
        for pid in path_ids:
            if pid in strain_dict:
                strain_dict.pop(pid)
        path_ins = list(path[0].in_neighbors())
        path_outs = list(path[-1].out_neighbors())
        if len(path_ins) == 0 and len(path_outs) == 0:
            logger.debug("contig already isolated; emitted directly as a strain")
            reduce_graph_cov(view, usages, full_link, path, pcov,
                             threshold, logger)
        elif len(path_ins) != 0 and len(path_outs) == 0:
            if len(path) > 1:
                logger.debug("still connected on the left; re-inserting path node")
                reduce_graph_cov(view, usages, full_link, path[1:], pcov,
                                 threshold, logger)
                pnode = view.add_vertex(
                    pno, pcov, path_to_seq(view, path[1:]))
                view.add_edge(path[0], pnode,
                              view.graph.edge(path[0], path[1]).overlap,
                              pcov)
                usages[pno] = 0
        elif len(path_ins) == 0 and len(path_outs) != 0:
            if len(path) > 1:
                logger.debug("still connected on the right; re-inserting path node")
                reduce_graph_cov(view, usages, full_link, path[:-1], pcov,
                                 threshold, logger)
                pnode = view.add_vertex(
                    pno, pcov, path_to_seq(view, path[:-1]))
                view.add_edge(pnode, path[-1],
                              view.graph.edge(path[-2], path[-1]).overlap,
                              pcov)
                usages[pno] = 0
        else:
            if len(path) > 1:
                logger.debug("still connected on both sides; re-inserting path node")
                reduce_graph_cov(view, usages, full_link, path[1:-1], pcov,
                                 threshold, logger)
                if len(path[1:-1]) > 0:
                    pnode = view.add_vertex(
                        pno, pcov, path_to_seq(view, path[1:-1]))
                    view.add_edge(path[0], pnode,
                                  view.graph.edge(path[0], path[1]).overlap,
                                  pcov)
                    view.add_edge(pnode, path[-1],
                                  view.graph.edge(path[-2],
                                                  path[-1]).overlap,
                                  pcov)
                    usages[pno] = 0

        view = store_reinit_graph(view, ckpt(f"graph_S{rid}post.gfa"),
                                  logger)
        for cno in list(contig_dict.keys()):
            if any(no not in view.nodes for no in contig_dict[cno][0]):
                contig_dict.pop(cno)
        rid += 1

    # drop duplicated split twins: same sequence, keep max depth
    # (Extension:743-757)
    seq_dict: Dict[str, list] = {}
    for node in view.graph.vertices():
        seq_dict.setdefault(node.seq, []).append(node)
    for _, sp_nodes in seq_dict.items():
        if len(sp_nodes) > 1:
            sorted_sp = sorted(sp_nodes, key=lambda v: v.dp, reverse=True)
            for vnode in sorted_sp[1:]:
                view.remove_vertex(vnode.vid)
                usages.pop(vnode.vid)
    view = store_reinit_graph(view, ckpt("graph_S_final.gfa"), logger)

    # pairwise link info on the final graph from the untouched PE copy,
    # computed lazily per requested pair — the reference precomputes all
    # V^2 pairs (Extension:765-799) although only in-neighbor x
    # out-neighbor pairs of non-trivial branches are ever read; lazy
    # evaluation gives the same values without the quadratic blowup on
    # large multi-component graphs
    id_expansion: Dict[str, list] = {}

    def expanded_ids(vid: str) -> list:
        if vid not in id_expansion:
            id_expansion[vid] = reduce_id_simple(
                reduce_Anode(vid, sno2ids))
        return id_expansion[vid]

    def final_link_between(v1: str, v2: str) -> int:
        total = 0
        for id1 in expanded_ids(v1):
            for id2 in expanded_ids(v2):
                total += pe_info[(min(id1, id2), max(id1, id2))]
        return total

    nt_branches = get_non_trivial_branches(view)
    final_links: Dict[str, dict] = {}
    for no, node in nt_branches.items():
        final_links[no] = {}
        us = [src.vid for src in node.in_neighbors()]
        ws = [tgt.vid for tgt in node.out_neighbors()]
        combs = []
        in_taken = dict.fromkeys(us, 0)
        out_taken = dict.fromkeys(ws, 0)
        for uid in us:
            for wid in ws:
                combs.append((uid, wid, final_link_between(uid, wid)))
        sorted_comb = sorted(combs, key=lambda x: x[2], reverse=True)
        for uid, wid, lf in sorted_comb:
            if lf > 0 and in_taken[uid] == 0 and out_taken[wid] == 0:
                logger.debug("final link kept %s->%s (count=%s)",
                             uid, wid, lf)
                final_links[no][(uid, wid)] = lf
                in_taken[uid] += 1
                out_taken[wid] += 1

    # extract remaining long unused nodes (Extension:834-875)
    for node in sorted(view.graph.vertices(),
                       key=lambda nd: len(nd.seq), reverse=True):
        if len(node.seq) <= 600:
            break
        if usages[node.vid] == 0:
            logger.debug("Extend from free node: %s", node.vid)
            path = final_extension(view, [node.vid], final_links, logger)
            pno = "N" + str(rid)
            plen = path_len(view, path)
            path_ids = [n.vid for n in path]
            pids = []
            for pid in path_ids:
                if pid in sno2ids:
                    pids.extend(sno2ids[pid])
                else:
                    pids.append(pid)
            for pid in path_ids:
                if pid in strain_dict:
                    strain_dict.pop(pid)
            pbubbles = get_bubble_nodes(view, path_ids)
            pcov = (float(numpy.median([n.dp for n in pbubbles]))
                    if len(pbubbles) != 0 else node.dp)
            logger.debug("---*extended from free node %s: %s", node.vid,
                         path_ids)
            logger.debug("name: %s, plen: %s, pcov: %s", pno, plen, pcov)
            strain_dict[pno] = [pids, plen, pcov]
            for pnode in path:
                usages[pnode.vid] += 1
            rid += 1
    for sno, [_, _, scov] in list(strain_dict.items()):
        if scov <= 2 * threshold:
            strain_dict.pop(sno)

    # expand strain ids back to base ids (Extension:881-897)
    for cno in strain_dict.keys():
        [contig, clen, ccov] = strain_dict[cno]
        rcontig = []
        for id_ in contig:
            rcontig.extend(reduce_id_simple(reduce_Anode(id_, sno2ids)))
        strain_dict[cno] = [rcontig, clen, ccov]

    return strain_dict, usages, view
