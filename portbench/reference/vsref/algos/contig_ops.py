"""Contig bookkeeping suite: inverted indices, dedup, remapping through
split trees, repeat resolution, end-to-end concatenation.

Parity: VStrains' utils/VStrains_Utilities.py:147-380, 577-836.
All host-side: contigs are short id lists over a tiny graph.
"""

from __future__ import annotations

import logging
from functools import reduce
from typing import Dict, List, Sequence, Set, Tuple

from portbench.reference.vsref.algos.pathmath import path_cov, path_len
from portbench.reference.vsref.core.graph import GraphView

_LOG = logging.getLogger(__name__)


def contig_map_node(contig_dict: dict):
    """Inverted node->contigs and edge->contigs indices
    (Utilities:227-244)."""
    node_to_contig_dict: Dict[str, Set[str]] = {}
    edge_to_contig_dict: Dict[Tuple[str, str], Set[str]] = {}
    for cno, (c, _, _) in contig_dict.items():
        for n in c:
            node_to_contig_dict.setdefault(n, set()).add(cno)
        for i in range(len(c) - 1):
            edge_to_contig_dict.setdefault((c[i], c[i + 1]), set()).add(cno)
    return node_to_contig_dict, edge_to_contig_dict


def trim_contig_dict(view: GraphView, contig_dict: dict,
                     logger: logging.Logger = None) -> dict:
    """De-duplicate nodes within each contig, recompute length
    (Utilities:147-159)."""
    logger = logger or _LOG
    logger.info("trim contig..")
    for cno, [contig, _, ccov] in list(contig_dict.items()):
        new_contig = list(dict.fromkeys(contig))
        contig_dict[cno] = [
            new_contig,
            path_len(view, [view.nodes[no] for no in new_contig]),
            ccov]
    logger.info("done")
    return contig_dict


def contig_resolve(contig_dict: dict) -> None:
    """Strip '&'-merges and '*'-splits back to base ids
    (Utilities:211-224)."""
    for cno in contig_dict.keys():
        [contig, clen, ccov] = contig_dict[cno]
        rcontig = []
        for id_ in contig:
            for iid in str(id_).split("&"):
                if iid.find("*") != -1:
                    rcontig.append(iid[: iid.find("*")])
                else:
                    rcontig.append(iid)
        contig_dict[cno] = [rcontig, clen, ccov]


def contig_cov_fix(view: GraphView, contig_dict: dict,
                   logger: logging.Logger = None) -> None:
    """Recompute each contig's coverage from current edge flows
    (Utilities:247-263)."""
    for cno, [contig, clen, _] in list(contig_dict.items()):
        contig_dict[cno][2] = path_cov(view, contig)
        if logger is not None:
            logger.debug("Contig: %s, length: %s, cov: %s Path: %s",
                         cno, clen, contig_dict[cno][2], contig)


def contig_low_cov_removal(contig_dict: dict, threshold: float,
                           logger: logging.Logger = None) -> None:
    """Drop contigs at or below the coverage threshold
    (Utilities:577-586)."""
    logger = logger or _LOG
    for cno in list(contig_dict.keys()):
        if contig_dict[cno][2] <= threshold:
            logger.debug("dropping contig %s: coverage %s is below the floor",
                         cno, contig_dict[cno][2])
            contig_dict.pop(cno)


def graph_reduction_c(view: GraphView, cand_path, usage_dict: dict,
                      cand_cov: float) -> None:
    """Subtract a path's coverage from nodes and edge flows
    (Utilities:266-278)."""
    for i in range(len(cand_path)):
        cand_path[i].dp -= cand_cov
        usage_dict[cand_path[i].vid] += 1
    for i in range(len(cand_path) - 1):
        e = view.graph.edge(cand_path[i], cand_path[i + 1])
        e.flow -= cand_cov


def contig_dup_removed_s(contig_dict: dict,
                         logger: logging.Logger = None) -> dict:
    """Remove duplicate / subset contigs by node-set equality
    (Utilities:589-616).

    The reference's O(C^2) all-pairs scan becomes an inverted-index walk
    over node-sharing pairs only: pairs with an empty intersection can
    never fire a rule (unless a contig is empty, handled explicitly), and
    related pairs are visited in the same dict order with the same
    at-visit-time dup guards, so the kept/dropped outcome is identical.
    """
    logger = logger or _LOG
    logger.info("removing duplicate/subset contigs..")
    keys = list(contig_dict.keys())
    order = {c: i for i, c in enumerate(keys)}
    sets = {c: set(contig_dict[c][0]) for c in keys}
    node2c: Dict[str, set] = {}
    for c in keys:
        for n in sets[c]:
            node2c.setdefault(n, set()).add(c)
    empties = [c for c in keys if not sets[c]]

    dup_contig_ids = set()
    for cno1 in keys:
        s1 = sets[cno1]
        if not s1:
            related = [c for c in keys if c != cno1]
        else:
            cand = set(empties)
            for n in s1:
                cand |= node2c.get(n, set())
            cand.discard(cno1)
            related = sorted(cand, key=order.get)
        l1 = len(s1)
        for cno2 in related:
            if (cno1 in dup_contig_ids or cno2 in dup_contig_ids):
                continue
            s2 = sets[cno2]
            inter = len(s1 & s2)
            if inter == l1 and inter == len(s2):
                dup_contig_ids.add(cno2)
            elif inter == l1:
                dup_contig_ids.add(cno1)
            elif inter == len(s2):
                dup_contig_ids.add(cno2)
    for cno in dup_contig_ids:
        contig_dict.pop(cno)
    logger.debug("duplicate contig ids: %s", dup_contig_ids)
    logger.info("done")
    return contig_dict


def contig_dict_remapping(view: GraphView, contig_dict: dict,
                          id_mapping: Dict[str, set],
                          prev_ids: Sequence[str],
                          logger: logging.Logger = None) -> Dict[str, set]:
    """Map contigs through a (possibly chained) split id_mapping; ambiguous
    multi-path mappings reduce to the intersection of all alternatives
    (Utilities:281-380)."""
    logger = logger or _LOG

    def map_contig_tree(contig, id_mappingP: dict):
        # sorted: set order is hash-randomized; path order decides the
        # ambiguity-intersection representative below
        if len(id_mappingP[contig[0]]) == 0:
            paths = [[contig[0]]]
        else:
            paths = [[s] for s in sorted(id_mappingP[contig[0]])]
        for i in range(1, len(contig)):
            acc_paths = []
            nxt = contig[i]
            for p in paths:
                last = p[-1]
                if len(id_mappingP[nxt]) == 0:
                    if (last, nxt) in view.edges:
                        acc_paths.append(p + [nxt])
                else:
                    for nextm in sorted(id_mappingP[nxt]):
                        if (last, nextm) in view.edges:
                            acc_paths.append(p + [nextm])
            paths = acc_paths
        return paths

    def merge_id(curr_set: set, myid):
        if len(curr_set) == 0:
            return set([myid])
        rtn_set = set()
        for id_ in curr_set:
            rtn_set = rtn_set.union(
                merge_id(id_mapping.get(id_, set()), id_))
        return rtn_set

    logger.info("expanding contig ids back to base nodes..")
    red_id_mapping: Dict[str, set] = {}
    for id_ in prev_ids:
        all_set = merge_id(id_mapping[id_], id_)
        red_id_mapping[id_] = all_set
        logger.debug("Node %s maps to %s", id_, all_set)

    for cno, (contig, _, ccov) in list(contig_dict.items()):
        logger.debug("remapping contig %s: %s", cno, contig)
        paths = map_contig_tree(contig, red_id_mapping)
        if len(paths) < 1:
            logger.debug("contig %s lost every node during remap: %s", cno, contig)
        elif len(paths) == 1:
            if paths[0] == contig:
                logger.debug("unique remap; keeping the original path")
            else:
                logger.debug("unique remap; substituting path %s", paths[0])
                contig_dict.pop(cno)
                contig_dict[cno] = [
                    paths[0],
                    path_len(view, [view.nodes[no] for no in paths[0]]),
                    ccov]
        else:
            contig_dict.pop(cno)
            logger.debug("multi mapping for contig %s: ambiguous, keep "
                         "intersection only", cno)
            final_path = reduce(lambda a, b: [i for i in a if i in b], paths)
            if len(final_path) > 0:
                sublen = path_len(view,
                                  [view.nodes[no] for no in final_path])
                contig_dict[cno] = [final_path, sublen, ccov]
    logger.info("done")
    return red_id_mapping


def check_contig_intersection(contig, contig2):
    """Classify the overlap between two contigs: parallel ('o'), or
    end-to-end forward/backward/double ('f'/'b'/'d'), or disjoint ('n')
    (Utilities:746-797)."""
    intersect = set(contig).intersection(set(contig2))
    if len(intersect) <= 0:
        return False, None, "n"

    if len(intersect) == len(contig) or len(intersect) == len(contig2):
        return True, None, "o"

    intersect_maps = [c in intersect for c in contig]
    prev_false_index = intersect_maps.index(False)
    for j in range(prev_false_index + 1, len(intersect_maps)):
        if not intersect_maps[j]:
            if prev_false_index + 1 == j:
                prev_false_index = j
            else:
                return True, None, "o"

    intersect_maps2 = [c in intersect for c in contig2]
    prev_false_index = intersect_maps2.index(False)
    for j in range(prev_false_index + 1, len(intersect_maps2)):
        if not intersect_maps2[j]:
            if prev_false_index + 1 == j:
                prev_false_index = j
            else:
                return True, None, "o"

    if contig[0] == contig2[0]:
        return True, None, "o"
    if contig[-1] == contig2[-1]:
        return True, None, "o"

    intersect_path = [n if intersect_maps[i] else None
                      for i, n in enumerate(contig)]
    direction = None
    if intersect_maps[0]:
        direction = "b"
    if intersect_maps[-1]:
        direction = "f" if direction is None else "d"
    return False, intersect_path, direction


def concat_overlap_contig(view: GraphView, contig_dict: dict,
                          logger: logging.Logger = None) -> None:
    """Merge end-to-end overlapping contigs along unique chains of the
    contig-overlap graph, pruning cycles first (Utilities:619-743).

    The reference uses graph-tool's all_circuits; we enumerate elementary
    circuits with Johnson's algorithm (algos/dag.py)."""
    from portbench.reference.vsref.algos.dag import elementary_circuits

    logger = logger or _LOG

    def self_loop(contig):
        return (contig[-1], contig[0]) in view.edges

    logger.info("joining contigs with end-to-end overlap..")
    contig_overlap_dict: Dict[str, list] = {k: [] for k in contig_dict}
    for cno, [contig, _, _] in contig_dict.items():
        for cno2, [contig2, _, _] in contig_dict.items():
            if cno == cno2:
                continue
            if self_loop(contig) or self_loop(contig2):
                continue
            isParallel, intersects, status = check_contig_intersection(
                contig, contig2)
            if not isParallel:
                if status in ["f", "d"]:
                    contig_overlap_dict[cno].append((cno2, intersects))
                elif status == "n":
                    if (view.nodes[contig2[0]]
                            in view.nodes[contig[-1]].out_neighbors()
                            and view.nodes[contig[0]]
                            in view.nodes[contig2[-1]].out_neighbors()):
                        contig_overlap_dict[cno].append((cno2, []))
    logger.debug("overlap candidates: %s", contig_overlap_dict)

    # overlap digraph over contig ids
    nodes_order = list(contig_overlap_dict.keys())
    out_adj: Dict[str, List[str]] = {c: [] for c in nodes_order}
    in_adj: Dict[str, List[str]] = {c: [] for c in nodes_order}
    concat_dict = {}
    for cno, cno2s in contig_overlap_dict.items():
        for cno2, intersects in cno2s:
            out_adj[cno].append(cno2)
            in_adj[cno2].append(cno)
            concat_dict[(cno, cno2)] = intersects

    circuits = elementary_circuits(nodes_order, out_adj)
    if circuits:
        for k, cyc in enumerate(circuits):
            logger.debug("current cyc: %s", cyc)
            unique_cyc = True
            for j, cyc2 in enumerate(circuits):
                if k != j and len(set(cyc).intersection(set(cyc2))) > 0:
                    unique_cyc = False
            for i in range(len(cyc)):
                u = cyc[i]
                v = cyc[(i + 1) % len(cyc)]
                for w in list(out_adj[u]):
                    if w != v or not unique_cyc:
                        out_adj[u].remove(w)
                        in_adj[w].remove(u)
                        concat_dict.pop((u, w), None)
            if unique_cyc:
                s, t = cyc[0], cyc[1]
                if t in out_adj[s]:
                    out_adj[s].remove(t)
                    in_adj[t].remove(s)
                    concat_dict.pop((s, t), None)

    has_del = True
    alive = set(nodes_order)
    while has_del:
        has_del = False
        for c in sorted(alive, key=nodes_order.index, reverse=True):
            ind = len(in_adj[c])
            outd = len(out_adj[c])
            if (ind == 0 and outd == 0) or (ind > 1 or outd > 1):
                for w in list(out_adj[c]):
                    out_adj[c].remove(w)
                    in_adj[w].remove(c)
                for u in list(in_adj[c]):
                    out_adj[u].remove(c)
                    in_adj[c].remove(u)
                alive.discard(c)
                has_del = True

    srcs = [c for c in nodes_order
            if c in alive and len(in_adj[c]) == 0]
    for src in srcs:
        contig_path = []
        curr = src
        while curr is not None:
            contig_path.append(curr)
            curr = out_adj[curr][0] if len(out_adj[curr]) == 1 else None
        concat_contig = []
        cnos = ""
        logger.debug("contig path: %s", contig_path)
        for ind, ccno in enumerate(contig_path):
            contig, _, _ = contig_dict.pop(ccno)
            if ind < len(contig_path) - 1:
                cnos += ccno + "&"
                vid = contig_path[ind + 1]
                intersect = concat_dict[(ccno, vid)]
                if intersect != []:
                    if intersect.count(None) > 0:
                        cut = list(reversed(intersect)).index(None)
                        contig = contig[:-cut]
                    else:
                        raise RuntimeError(
                            f"invalid overlap: {contig} {intersect}")
            else:
                cnos += ccno
            concat_contig.extend(contig)
        logger.debug("merging end-overlapping pair %s -> %s",
                     cnos, concat_contig)
        concat_len = path_len(view,
                              [view.nodes[id_] for id_ in concat_contig])
        concat_cov = path_cov(view, concat_contig)
        contig_dict[cnos] = [concat_contig, concat_len, concat_cov]
    logger.info("done")


def strain_repeat_resol(view: GraphView, strain_dict: dict,
                        contig_info: dict, copy_contig_dict: dict,
                        logger: logging.Logger = None) -> None:
    """Re-insert repeated node copies into strains using the per-contig
    repeat multiplicities recorded at parse time (Utilities:800-836)."""
    logger = logger or _LOG
    logger.info("re-inserting repeated node copies..")
    for sno, [strain, _, scov] in list(strain_dict.items()):
        cnos = set()
        subids = []
        for id_ in strain:
            for iid in str(id_).split("&"):
                if iid.find("*") != -1:
                    iid = iid[: iid.find("*")]
                subids.append(iid)
        for cno, [contig, _, _] in copy_contig_dict.items():
            if set(contig).issubset(set(subids)):
                cnos.add(cno)

        repeat_dec = dict.fromkeys(subids, 1)
        for cno in cnos:
            (_, repeat_dict) = contig_info[cno]
            for no, rpc in repeat_dict.items():
                repeat_dec[no] = max(repeat_dec[no], rpc)
        strain_r: List[str] = []
        for id_ in subids:
            strain_r.extend([id_] * repeat_dec[id_])
        strain_dict[sno] = [
            strain_r,
            path_len(view, [view.nodes[no] for no in strain_r]),
            scov]
    logger.info("done")
