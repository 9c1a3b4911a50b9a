"""Iterative graph disentanglement: branch splitting driven by contig,
paired-end-link and coverage evidence.

Parity: VStrains' utils/VStrains_Decomposition.py
  - link_split / cov_split        (:7-88)
  - balance_split                 (:91-530, minus dev-mode minimap2 scoring)
  - trivial_split                 (:533-688)
  - global_trivial_split          (:691-819)
  - edge_cleaning                 (:822-905)
  - iter_graph_disentanglement    (:908-1042)

Host orchestration by design: each branch decision touches a handful of
scalars; the graph numeric state (flows, depths) is (re)computed by the
batched device pass in ops/graph_ops between rounds. Where the reference
iterates CPython `set(...)` of neighbors (order an interpreter artifact), we
pin adjacency insertion order.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from portbench.reference.vsref.algos.branches import (get_non_trivial_branches,
                                         is_non_trivial)
from portbench.reference.vsref.algos.compact import simp_path_compactification
from portbench.reference.vsref.algos.contig_ops import (contig_dict_remapping,
                                           contig_dup_removed_s,
                                           contig_map_node,
                                           trim_contig_dict)
from portbench.reference.vsref.core.gfa import store_reinit_graph
from portbench.reference.vsref.core.pe_store import pe_normalize_none, pe_pop_node
from portbench.reference.vsref.core.graph import BLACK, GraphView

_LOG = logging.getLogger(__name__)


def link_split(cand_links: list, accepted_links: dict, in_taken: dict,
               in_capacity: dict, out_taken: dict, out_capacity: dict,
               logger: logging.Logger) -> None:
    """Primary phase: accept every positive PE link, strongest first
    (Decomposition:7-29)."""
    logger.debug("primary phase: resolving links by PE evidence")
    ranked_cands = sorted(cand_links, key=lambda x: x[2], reverse=True)
    for uid, wid, pe in ranked_cands:
        if pe <= 0:
            break
        logger.debug("candidate link %s->%s (pe=%s)", uid, wid, pe)
        logger.debug("flow capacity in=%s out=%s", in_capacity[uid],
                     out_capacity[wid])
        logger.debug("accepted: positive PE support")
        in_taken[uid] += 1
        out_taken[wid] += 1
        accepted_links[(uid, wid)] = ((in_capacity[uid] + out_capacity[wid]) / 2,
                                 pe)


def cov_split(us: list, ws: list, pe_info: dict, cand_links: list,
              accepted_links: dict, in_taken: dict, in_capacity: dict,
              out_taken: dict, out_capacity: dict,
              logger: logging.Logger) -> None:
    """Secondary phase: PE links to isolated leaves first, then mutual-best
    coverage matches guarded by a 2|delta| ambiguity test
    (Decomposition:31-88)."""
    logger.debug("secondary phase: resolving links by coverage")
    ranked_cands = sorted(cand_links, key=lambda x: x[2], reverse=True)
    for uid, wid, pe in ranked_cands:
        if pe <= 0:
            break
        if in_taken[uid] > 0 or out_taken[wid] > 0:
            continue
        logger.debug("candidate link %s->%s (pe=%s)", uid, wid, pe)
        logger.debug("accepted: nonzero PE on an unused pair")
        in_taken[uid] += 1
        out_taken[wid] += 1
        accepted_links[(uid, wid)] = ((in_capacity[uid] + out_capacity[wid]) / 2,
                                 pe)

    logger.debug("matching leftover ends by closest coverage")
    for uid in us:
        if in_taken[uid] > 0:
            continue
        opt_ws = sorted(ws, key=lambda wwid: abs(in_capacity[uid]
                                                 - out_capacity[wwid]))
        wid = opt_ws[0]
        opt_us = sorted(us, key=lambda uuid: abs(in_capacity[uuid]
                                                 - out_capacity[wid]))
        if (opt_us[0] == uid and out_taken[wid] == 0
                and (uid, wid) not in accepted_links):
            delta = 2 * abs(in_capacity[uid] - out_capacity[wid])
            logger.debug("closest-coverage pair %s->%s "
                         "(in=%s out=%s, ambiguity bound %s)", uid, wid,
                         in_capacity[uid], out_capacity[wid], delta)
            if (abs(in_capacity[opt_us[1]] - out_capacity[wid]) <= delta
                    or abs(in_capacity[uid] - out_capacity[opt_ws[1]])
                    <= delta):
                logger.debug("runner-up falls inside the ambiguity bound; skipping")
            else:
                logger.debug("accepted: mutual best coverage match")
                in_taken[uid] += 1
                out_taken[wid] += 1
                accepted_links[(uid, wid)] = (
                    (in_capacity[uid] + out_capacity[wid]) / 2,
                    pe_info[(min(uid, wid), max(uid, wid))])


def balance_split(view: GraphView, contig_dict: dict, pe_info: dict,
                  threshold: float, is_prim: bool,
                  logger: logging.Logger = None,
                  scorer=None) -> int:
    """Resolve N-N non-trivial branches into per-link child nodes `no*i`
    (Decomposition:91-530). Returns the number of branches split.

    `scorer` (evals.refmap.SplitScorer, dev mode) labels every kept link
    Correct/False-Positive/Error against reference strains and emits the
    scatter artifact per pass (reference Decomposition:209-251, 362-416,
    509-529)."""
    logger = logger or _LOG
    logger.info("balance split pass (contig + PE + coverage evidence), "
                "primary=%s", is_prim)

    non_trivial_branches = get_non_trivial_branches(view)
    split_branches: List[str] = []
    node_to_contig_dict, _ = contig_map_node(contig_dict)
    # nodes split earlier in THIS call: their PE pairs are unknown until
    # the next inference round (the reference marks every pair None and
    # normalizes at the end, Decomposition:493-503 — O(N) per new node;
    # a call-local set is equivalent and O(1))
    fresh_nodes: set = set()
    for no, node in non_trivial_branches.items():
        us = [e.source.vid for e in node.in_edges() if e.color == BLACK]
        ws = [e.target.vid for e in node.out_edges() if e.color == BLACK]
        logger.debug("---------------------------------------------")
        logger.debug("resolving non-trivial branch %s (in-degree %s, "
                     "out-degree %s)", no, len(us), len(ws))

        # authenticate if split-able
        if (any(uid in fresh_nodes or pe_info[(uid, uid)] is None
                for uid in us)
                or any(wid in fresh_nodes or pe_info[(wid, wid)] is None
                       for wid in ws)):
            logger.debug("branch %s is related to current iteration, "
                         "split later", no)
            continue
        if not is_non_trivial(node):
            logger.debug("branch %s is not non-trivial, potential bug", no)
            continue
        if len(us) != len(ws):
            logger.debug("in/out degree unequal; branch left alone")
            continue

        split_via_link = True
        # no link-split if any leaf is purely made of split nodes
        for id_ in us + ws:
            singles = id_.split("&")
            if all(single.count("*") > 0 for single in singles):
                logger.debug("leaf:%s is total branch nodes, no link "
                             "information, skip link split", id_)
                split_via_link = False
                break
        # no link-split if no combination has link information
        if all(pe_info[(min(uid, wid), max(uid, wid))] == 0
               for uid in us for wid in ws):
            logger.debug("branch node too long, no link information, "
                         "skip link split")
            split_via_link = False

        # contig-spanning support (sorted: set iteration order is
        # hash-randomized and re-insertion order feeds later greedy
        # tie-breaks — the reference is nondeterministic here)
        support_contigs = sorted(node_to_contig_dict.get(no, []))
        con_info: Dict[Tuple[str, str], list] = {}
        for cno in support_contigs:
            [contig, clen, ccov] = contig_dict[cno]
            loc = contig.index(no)
            if 0 < loc < len(contig) - 1:
                con_info.setdefault((contig[loc - 1], contig[loc + 1]),
                                    []).append((cno, clen, ccov))
            logger.debug("support contig %s len %s cov %s: %s", cno, clen,
                         round(ccov, 2), contig[max(loc - 1, 0): loc + 2])

        accepted_links: Dict[Tuple[str, str], tuple] = {}
        cand_links: List[tuple] = []
        in_taken = dict.fromkeys(us, 0)
        in_capacity = {uid: view.edges[(uid, no)].flow for uid in us}
        out_taken = dict.fromkeys(ws, 0)
        out_capacity = {wid: view.edges[(no, wid)].flow for wid in ws}

        logger.debug("contig-spanned links take precedence")
        for uid in us:
            for wid in ws:
                logger.debug("---------------------")
                curr_pe = pe_info[(min(uid, wid), max(uid, wid))]
                logger.debug("%s -> %s PE: %s", uid, wid, curr_pe)
                accept = False
                if (uid, wid) in con_info:
                    logger.debug("link supported by contig: %s, added",
                                 con_info[(uid, wid)])
                    accept = True
                if uid == wid:
                    logger.debug("self link: %s, potential cyclic strain, "
                                 "added", uid)
                    accept = True
                if accept:
                    in_taken[uid] += 1
                    out_taken[wid] += 1
                    accepted_links[(uid, wid)] = (
                        (in_capacity[uid] + out_capacity[wid]) / 2, curr_pe)
                else:
                    logger.debug("secondary choice, process later")
                    cand_links.append((uid, wid, curr_pe))

        if is_prim:
            if split_via_link:
                link_split(cand_links, accepted_links, in_taken, in_capacity,
                           out_taken, out_capacity, logger)
        else:
            cov_split(us, ws, pe_info, cand_links, accepted_links, in_taken,
                      in_capacity, out_taken, out_capacity, logger)

        if not (all(u == 1 for u in in_taken.values())
                and all(v == 1 for v in out_taken.values())):
            logger.debug("branch usage is not a perfect 1-1 matching; "
                         "skipping split: %s", accepted_links)
            continue
        worst_pair_diff = max(abs(in_capacity[uid] - out_capacity[wid])
                              for (uid, wid) in accepted_links.keys())
        if worst_pair_diff > 4 * threshold:
            logger.debug("worst pair coverage diff > 4 delta: %s > %s, too "
                         "uneven, skip: %s", worst_pair_diff, 4 * threshold,
                         accepted_links)
            continue
        logger.debug("splitting branch; accepted link set: %s",
                     accepted_links)
        if scorer is not None:
            scorer.score_branch(view, no, us, ws, accepted_links)

        split_branches.append(no)
        link_to_children: Dict[Tuple[str, str], str] = {}
        counter = 0
        for (uid, wid), (sub_flow, pe) in accepted_links.items():
            logger.debug("--------> %s - %s", uid, wid)
            sub_id = no + "*" + str(counter)
            counter += 1
            sub_node = view.add_vertex(sub_id, sub_flow, node.seq)
            view.add_edge(view.nodes[uid], sub_node,
                          view.edges[(uid, no)].overlap, sub_flow)
            view.add_edge(sub_node, view.nodes[wid],
                          view.edges[(no, wid)].overlap, sub_flow)
            link_to_children[(uid, wid)] = sub_id

        # remap contigs crossing the branch (Decomposition:443-482);
        # the node->contigs index is updated incrementally (the reference
        # rebuilds it fully per split, Decomposition:490 — O(C) per split)
        removed_contents = {}
        added_cnos = []
        for cno in sorted(support_contigs):
            curr_contig, clen, ccov = contig_dict.pop(cno)
            removed_contents[cno] = list(curr_contig)
            branch_ind = curr_contig.index(no)
            uid = curr_contig[branch_ind - 1] if branch_ind > 0 else None
            wid = (curr_contig[branch_ind + 1]
                   if branch_ind < len(curr_contig) - 1 else None)
            if uid is not None and wid is not None:
                curr_contig[branch_ind] = link_to_children[(uid, wid)]
                contig_dict[cno] = [curr_contig, clen, ccov]
                added_cnos.append(cno)
            elif uid is None and wid is None:
                for sub_id in link_to_children.values():
                    new_cno = cno + "$" + str(sub_id.split("*")[-1])
                    contig_dict[new_cno] = [
                        [sub_id],
                        len(view.nodes[sub_id].seq),
                        view.nodes[sub_id].dp]
                    added_cnos.append(new_cno)
            elif uid is not None and wid is None:
                for (uid2, _), sub_id in link_to_children.items():
                    if uid == uid2:
                        curr_contig[branch_ind] = sub_id
                        new_cno = cno + "$" + str(sub_id.split("*")[-1])
                        contig_dict[new_cno] = [list(curr_contig), clen,
                                                ccov]
                        added_cnos.append(new_cno)
            else:
                for (_, wid2), sub_id in link_to_children.items():
                    if wid == wid2:
                        curr_contig[branch_ind] = sub_id
                        new_cno = cno + "$" + str(sub_id.split("*")[-1])
                        contig_dict[new_cno] = [list(curr_contig), clen,
                                                ccov]
                        added_cnos.append(new_cno)

        # drop the old branch and its edges
        for uid in us:
            view.remove_edge(uid, no)
        for wid in ws:
            view.remove_edge(no, wid)
        view.remove_vertex(no)
        for cno, contents in removed_contents.items():
            for n in contents:
                cnos = node_to_contig_dict.get(n)
                if cnos is not None:
                    cnos.discard(cno)
        for cno in added_cnos:
            for n in contig_dict[cno][0]:
                node_to_contig_dict.setdefault(n, set()).add(cno)

        # invalidate PE info for the new ids (Decomposition:493-503)
        for (uid, wid), sub_id in link_to_children.items():
            fresh_nodes.add(sub_id)
        pe_pop_node(pe_info, no)

    pe_normalize_none(pe_info)
    if scorer is not None:
        scorer.plot_pass()
    logger.debug("branches split this round: %s", len(set(split_branches)))
    logger.debug("split branch ids: %s", set(split_branches))
    logger.info("done")
    return len(set(split_branches))


def _fork_node(view: GraphView, node, keep_edge, fork_edges, fork_in: bool,
               pe_info, id_mapping) -> None:
    """Fork a 1-n (or n-1) node into one copy per many-side edge.

    fork_in=True: n->1 case, fork over in-edges; keep_edge is the single
    out-edge. fork_in=False: 1->n case, fork over out-edges; keep_edge is
    the single in-edge.
    """
    no = node.vid
    node.color = "gray"
    keep_edge.color = "gray"
    for i, fe in enumerate(fork_edges):
        sub_id = no + "*" + chr(ord("A") + i)
        snode = view.add_vertex(sub_id, fe.flow, node.seq)
        fe.color = "gray"
        if fork_in:
            view.edges.pop((fe.source.vid, no), None)
            view.add_edge(fe.source, snode, fe.overlap, fe.flow)
            view.add_edge(snode, keep_edge.target, keep_edge.overlap,
                          fe.flow)
        else:
            view.edges.pop((no, fe.target.vid), None)
            view.add_edge(snode, fe.target, fe.overlap, fe.flow)
            view.add_edge(keep_edge.source, snode, keep_edge.overlap,
                          fe.flow)
        id_mapping[no].add(sub_id)
    if fork_in:
        view.edges.pop((no, keep_edge.target.vid), None)
    else:
        view.edges.pop((keep_edge.source.vid, no), None)
    if pe_info is not None:
        pe_pop_node(pe_info, no)


def trivial_split(view: GraphView, pe_info: dict,
                  logger: logging.Logger = None
                  ) -> Tuple[int, Dict[str, set]]:
    """Fork (n->1)/(1->n) neighbors of non-trivial branches
    (Decomposition:533-688). Returns (count, id_mapping old->new)."""
    logger = logger or _LOG
    logger.info("trivial forking around non-trivial branches..")
    non_trivial_branches = get_non_trivial_branches(view)
    trivial_split_count = 0
    id_mapping: Dict[str, set] = {id_: set() for id_ in view.nodes.keys()}

    for ntno, ntnode in non_trivial_branches.items():
        if ntnode.color != BLACK:
            continue
        logger.debug("Current involving NT branch: %s", ntno)
        for inode in list(dict.fromkeys(ntnode.in_neighbors())):
            if inode.color != BLACK:
                continue
            ino = inode.vid
            id_mapping.setdefault(ino, set())
            ines = [ue for ue in inode.in_e if ue.color == BLACK]
            outes = [ve for ve in inode.out_e if ve.color == BLACK]
            if len(ines) > 1 and len(outes) == 1:
                logger.debug("%s: fanning the n->1 edge into its right-side copies", ino)
                _fork_node(view, inode, view.graph.edge(inode, ntnode),
                           ines, True, pe_info, id_mapping)
                view.nodes.pop(ino, None)
                trivial_split_count += 1

        for onode in list(dict.fromkeys(ntnode.out_neighbors())):
            if onode.color != BLACK:
                continue
            ono = onode.vid
            id_mapping.setdefault(ono, set())
            ines = [ue for ue in onode.in_e if ue.color == BLACK]
            outes = [ve for ve in onode.out_e if ve.color == BLACK]
            if len(ines) == 1 and len(outes) > 1:
                logger.debug("%s: fanning the 1->n edge into its left-side copies", ono)
                _fork_node(view, onode, view.graph.edge(ntnode, onode),
                           outes, False, pe_info, id_mapping)
                view.nodes.pop(ono, None)
                trivial_split_count += 1

    pe_normalize_none(pe_info)
    logger.debug("Total split-ted trivial branch count: %s",
                 trivial_split_count)
    return trivial_split_count, id_mapping


def global_trivial_split(view: GraphView, logger: logging.Logger = None
                         ) -> Tuple[int, Dict[str, set]]:
    """Fork every (n->1)/(1->n) node until fixed point
    (Decomposition:691-819)."""
    logger = logger or _LOG
    logger.info("global trivial forking pass..")
    BOUND_ITER = len(view.nodes) ** 2
    has_split = True
    trivial_split_count = 0
    id_mapping: Dict[str, set] = {id_: set() for id_ in view.nodes.keys()}
    while has_split and trivial_split_count < BOUND_ITER:
        has_split = False
        for id_ in list(view.nodes.keys()):
            node = view.nodes.get(id_)
            if node is None or node.color != BLACK:
                continue
            id_mapping.setdefault(id_, set())
            ines = [ue for ue in node.in_e if ue.color == BLACK]
            outes = [ve for ve in node.out_e if ve.color == BLACK]
            if len(ines) == 1 and len(outes) > 1:
                logger.debug("%s: forked on the left side", id_)
                _fork_node(view, node, ines[0], outes, False, None,
                           id_mapping)
                view.nodes.pop(id_, None)
                has_split = True
                trivial_split_count += 1
            elif len(ines) > 1 and len(outes) == 1:
                logger.debug("%s: forked on the right side", id_)
                _fork_node(view, node, outes[0], ines, True, None,
                           id_mapping)
                view.nodes.pop(id_, None)
                has_split = True
                trivial_split_count += 1
    if trivial_split_count >= BOUND_ITER:
        logger.warning("unexpected degree pattern mid-fork; abandoning node "
                       "immediately")
        return None, id_mapping
    logger.debug("trivial forks resolved: %s", trivial_split_count)
    logger.info("done")
    return trivial_split_count, id_mapping


def edge_cleaning(view: GraphView, contig_dict: dict, pe_info: dict,
                  logger: logging.Logger = None) -> dict:
    """Keep confident edges only: fixed-point unique-in/out assignment, then
    contig-forced assignment, then drop unsupported crossing edges
    (Decomposition:822-905)."""
    logger = logger or _LOG
    un_assigned_edge = view.graph.num_edges()
    assigned = dict.fromkeys(
        [(e.source.vid, e.target.vid) for e in view.graph.edges()], False)
    _, edge_to_contig_dict = contig_map_node(contig_dict)
    logger.debug("Total edges: %s", un_assigned_edge)
    converage_flag = 0
    while True:
        for node in view.graph.vertices():
            in_d = node.in_degree()
            in_e = []
            for e in node.in_e:
                if assigned[(e.source.vid, e.target.vid)]:
                    in_d -= 1
                else:
                    in_e.append(e)
            out_d = node.out_degree()
            out_e = []
            for e in node.out_e:
                if assigned[(e.source.vid, e.target.vid)]:
                    out_d -= 1
                else:
                    out_e.append(e)
            if in_d == 1:
                assigned[(in_e[0].source.vid, in_e[0].target.vid)] = True
                un_assigned_edge -= 1
            if out_d == 1:
                assigned[(out_e[0].source.vid, out_e[0].target.vid)] = True
                un_assigned_edge -= 1
        if converage_flag == un_assigned_edge:
            break
        converage_flag = un_assigned_edge

    logger.debug("un-assigned edges after node-weight coverage iteration: "
                 "%s", un_assigned_edge)
    for u, v in assigned.keys():
        if not assigned[(u, v)]:
            logger.debug("***cross un-assigned edge: %s -> %s, with paired "
                         "end link %s", u, v,
                         pe_info[(min(u, v), max(u, v))])
            if (u, v) in edge_to_contig_dict:
                logger.debug("support contig: %s, force assign",
                             edge_to_contig_dict[(u, v)])
                assigned[(u, v)] = True
            else:
                logger.debug("no contig spans this link")
    for u, v in assigned.keys():
        if not assigned[(u, v)]:
            force_assign = True
            for w, z in assigned.keys():
                if (u == w or v == z) and assigned[(w, z)]:
                    force_assign = False
                    break
            if not force_assign:
                view.graph.remove_edge(view.edges.pop((u, v)))
                logger.debug("intersect unsupported edge: %s -> %s, "
                             "removed", u, v)
            else:
                logger.debug("disjoint unsupported edge: %s -> %s, kept",
                             u, v)
    return assigned


def iter_graph_disentanglement(view: GraphView, contig_dict: dict,
                               pe_info: dict, threshold: float,
                               temp_dir: str = None,
                               logger: logging.Logger = None,
                               scorer=None) -> GraphView:
    """Outer fixed-point driver over primary (link) then secondary
    (coverage) split phases (Decomposition:908-1042)."""
    logger = logger or _LOG
    BOUND_ITER = len(view.nodes) ** 2
    it = 0
    total_removed_branch = 0
    iterCount = "A"

    def ckpt(name):
        return f"{temp_dir}/gfa/{name}" if temp_dir else None

    for is_prim in [True, False]:
        do_trivial_split = True
        while it < BOUND_ITER:
            num_split = balance_split(view, contig_dict, pe_info, threshold,
                                      is_prim, logger, scorer=scorer)
            view = store_reinit_graph(
                view, ckpt(f"split_graph_L{iterCount}d.gfa"), logger)
            simp_path_compactification(view, contig_dict, pe_info, logger)
            view = store_reinit_graph(
                view, ckpt(f"split_graph_L{iterCount}dc.gfa"), logger)

            if num_split > 0:
                do_trivial_split = True
            else:
                if do_trivial_split:
                    prev_ids = list(view.nodes.keys())
                    _count, id_mapping = trivial_split(view, pe_info,
                                                       logger)
                    logger.debug("my id mapping: %s", id_mapping)
                    view = store_reinit_graph(
                        view, ckpt(f"split_graph_L{iterCount}dct.gfa"),
                        logger)
                    contig_dict_remapping(view, contig_dict, id_mapping,
                                          prev_ids, logger)
                    simp_path_compactification(view, contig_dict, pe_info,
                                               logger)
                    view = store_reinit_graph(
                        view, ckpt(f"split_graph_L{iterCount}dctd.gfa"),
                        logger)

            contig_dup_removed_s(contig_dict, logger)
            trim_contig_dict(view, contig_dict, logger)
            total_removed_branch += num_split
            it += 1
            iterCount = chr(ord(iterCount) + 1)
            if num_split == 0:
                if do_trivial_split:
                    do_trivial_split = False
                else:
                    break

    logger.debug("non-trivial branches resolved in total: %s",
                 total_removed_branch)
    non_trivial_branches = get_non_trivial_branches(view)
    logger.debug("non-trivial branches (%s) left after paired-end&"
                 "single-strand links: %s", len(non_trivial_branches),
                 list(non_trivial_branches.keys()))
    view = store_reinit_graph(view, ckpt("split_graph_final.gfa"), logger)
    return view
