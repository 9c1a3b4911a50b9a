"""SPAdes contigs.paths parsing and contig/strain output writers.

Parity: VStrains' utils/VStrains_IO.py:375-595 (is_valid,
spades_paths_parser, contig_dict_to_fasta, contig_dict_to_path).

contig_dict entries are [node_id_list, length, coverage]; contig_info maps
cno -> (None, repeat_dict) recording per-node repeat multiplicity used by the
final repeat resolution stage.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.reference.vsref.algos.pathmath import path_len, path_ids_to_seq
from portbench.reference.vsref.core.graph import GraphView


class PathsFormatError(Exception):
    pass


def is_valid(p: List[str], idx_mapping: dict, view: GraphView) -> bool:
    """A subpath is valid iff every node maps into the live graph and every
    consecutive pair is a live edge (VStrains_IO.py:375-395)."""
    if len(p) == 0:
        return False
    if len(p) == 1:
        if p[0] not in idx_mapping:
            return False
        if idx_mapping[p[0]] not in view.nodes:
            return False
        return True
    for i in range(len(p) - 1):
        if p[i] not in idx_mapping or p[i + 1] not in idx_mapping:
            return False
        mu = idx_mapping[p[i]]
        mv = idx_mapping[p[i + 1]]
        if mu not in view.nodes:
            return False
        if mv not in view.nodes:
            return False
        if (mu, mv) not in view.edges:
            return False
    return True


def _oriented(v: str) -> str:
    return str(v[:-1]) if v[-1] == "+" else "-" + str(v[:-1])


def spades_paths_parser(view: GraphView, idx_mapping: dict,
                        path_file: str, min_len: int = 250,
                        min_cov: float = 0,
                        logger: logging.Logger = None
                        ) -> Tuple[dict, dict]:
    """Parse SPAdes .paths records (fwd + reverse-prime pairs), validate
    subpaths against the graph, keep the orientation with more mapped nodes
    (VStrains_IO.py:398-515)."""
    logger = logger or logging.getLogger(__name__)
    logger.info("reading SPAdes contigs.paths..")

    def get_paths(fd, path):
        subpaths = []
        total_nodes = 0
        while path.endswith(";\n"):
            subpath = [_oriented(v) for v in str(path[:-2]).split(",")]
            subpathred = list(dict.fromkeys(subpath))
            if is_valid(subpathred, idx_mapping, view):
                subpath = [idx_mapping[v] for v in subpath]
                subpaths.append(subpath)
                total_nodes += len(subpath)
            path = fd.readline()

        subpath = [_oriented(v) for v in path.rstrip().split(",")]
        subpathred = list(dict.fromkeys(subpath))
        if is_valid(subpathred, idx_mapping, view):
            subpath = [idx_mapping[v] for v in subpath]
            subpaths.append(subpath)
            total_nodes += len(subpath)
        return subpaths, total_nodes

    contig_dict: Dict[str, list] = {}
    contig_info: Dict[str, tuple] = {}
    try:
        with open(path_file, "r") as contigs_file:
            name = contigs_file.readline()
            path = contigs_file.readline()

            while name != "" and path != "":
                (cno, clen, ccov) = re.search(
                    "%s(.*)%s(.*)%s(.*)" % ("NODE_", "_length_", "_cov_"),
                    name.strip()).group(1, 2, 3)
                subpaths, total_nodes = get_paths(contigs_file, path)

                name_r = contigs_file.readline()
                path_r = contigs_file.readline()
                (cno_r, clen_r, ccov_r) = re.search(
                    "%s(.*)%s(.*)%s(.*)%s" % ("NODE_", "_length_", "_cov_",
                                              "'"),
                    name_r.strip()).group(1, 2, 3)
                subpaths_r, total_nodes_r = get_paths(contigs_file, path_r)

                if not (cno == cno_r and clen == clen_r and ccov == ccov_r):
                    raise PathsFormatError(
                        f"mismatched contig pair {cno}/{cno_r}")

                name = contigs_file.readline()
                path = contigs_file.readline()

                # pick one direction only: the one mapping more nodes
                (segments, total_n) = max(
                    [(subpaths, total_nodes), (subpaths_r, total_nodes_r)],
                    key=lambda t: t[1])

                if segments == []:
                    continue
                if total_n < 2 and (float(ccov) <= min_cov
                                    or int(clen) < min_len):
                    continue
                for i, subpath in enumerate(segments):
                    repeat_dict: Dict[str, int] = {}
                    for k in subpath:
                        repeat_dict[k] = repeat_dict.get(k, 0) + 1
                    subpath = list(dict.fromkeys(subpath))

                    if len(segments) != 1:
                        contig_dict[cno + "$" + str(i)] = [
                            subpath,
                            path_len(view,
                                     [view.nodes[id] for id in subpath]),
                            float(ccov)]
                        contig_info[cno + "$" + str(i)] = (None, repeat_dict)
                    else:
                        contig_dict[cno] = [subpath, int(clen), float(ccov)]
                        contig_info[cno] = (None, repeat_dict)
    except PathsFormatError:
        raise
    except Exception as err:
        raise PathsFormatError(
            f"{err}\nPlease make sure the correct SPAdes contigs .paths "
            "file is provided.") from err
    logger.debug(str(contig_dict))
    logger.debug(str(contig_info))
    logger.info("done")
    return contig_dict, contig_info


def contig_dict_to_fasta(view: GraphView, contig_dict: dict,
                         output_file: str) -> None:
    """FASTA dump, longest-first (VStrains_IO.py:518-537)."""
    with open(output_file, "w") as fasta:
        for cno, (contig, clen, ccov) in sorted(
                contig_dict.items(), key=lambda x: x[1][1], reverse=True):
            contig_name = (">" + str(cno) + "_" + str(clen) + "_"
                           + str(round(ccov, 2)) + "\n")
            seq = path_ids_to_seq(view, contig) + "\n"
            fasta.write(contig_name)
            fasta.write(seq)


def contig_dict_to_path(contig_dict: dict, output_file: str,
                        id_mapping: Optional[dict] = None,
                        keep_original: bool = False) -> None:
    """.paths dump; with keep_original, split-ids are resolved back through
    the reindexing map and '-X' renders as 'X-' (VStrains_IO.py:558-595)."""
    rev_id_mapping = {}
    if id_mapping is not None:
        for id_, mapped in id_mapping.items():
            rev_id_mapping[mapped] = id_
    with open(output_file, "w") as paths:
        for cno, (contig, clen, ccov) in sorted(
                contig_dict.items(), key=lambda x: x[1][1], reverse=True):
            contig_name = ("NODE_" + str(cno) + "_" + str(clen) + "_"
                           + str(ccov) + "\n")
            path_ids = ""
            for id_ in contig:
                for iid in str(id_).split("&"):
                    if iid.find("*") != -1:
                        iid = iid[: iid.find("*")]
                    if keep_original:
                        rid = rev_id_mapping[iid]
                        if rid[0] == "-":
                            rid = rid[1:] + "-"
                        path_ids += rid + ","
                    else:
                        path_ids += str(iid) + ","
            path_ids = path_ids[:-1] + "\n"
            paths.write(contig_name)
            paths.write(path_ids)
