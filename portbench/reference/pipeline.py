"""The reference run of one sample: the stages of the program's pipeline
as of commit bc5e135ef114cb1be5519b7422aa36d058e4b564
(`vstrains_tpu_torch/pipeline.py`, `_run`, with the CLI's defaults: no
resume, reference genome, tip removal or per-component stage; the same
files written, bar the checkpoints) over the frozen host stages in
`vsref/`, with the PE links from `pe_links.py` in place of the
program's engine.

`run_sample` writes `gfa/split_graph_final.gfa`, `strain.fasta` and
`strain.paths` under its output directory, as the program does, and
returns the node ids of the PE stage with the link matrices.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy

from portbench.reference import pe_links
from portbench.reference.vsref.algos.branches import \
    increment_nt_branch_coverage
from portbench.reference.vsref.algos.contig_ops import (
    contig_dup_removed_s, contig_resolve, strain_repeat_resol,
    trim_contig_dict)
from portbench.reference.vsref.algos.decomposition import (
    edge_cleaning, iter_graph_disentanglement)
from portbench.reference.vsref.algos.extension import (best_matching,
                                                       path_extension)
from portbench.reference.vsref.algos.preprocess import (graph_simplification,
                                                        reindexing)
from portbench.reference.vsref.core.canon import load_gfa_canonized
from portbench.reference.vsref.core.contig_io import (contig_dict_to_fasta,
                                                      contig_dict_to_path,
                                                      spades_paths_parser)
from portbench.reference.vsref.core.gfa import (load_flipped_gfa,
                                                store_reinit_graph,
                                                write_gfa)
from portbench.reference.vsref.core.pe_store import PEInfo
from portbench.reference.vsref.graph_ops import threshold_estimation

_LOG = logging.getLogger("portbench.reference")


def pe_info_from_links(ids: List[str], node_mat, short_mat):
    """The symmetric PE-link stores from dense matrices, as
    `pe_info_sparse_from_result` (`vstrains_tpu_torch/ops/pe_infer.py`)
    builds them: (min, max) id keys, both orders summed off the diagonal,
    zero pairs absent."""
    total = node_mat + short_mat
    sym = total + total.T
    pe = PEInfo()
    iu, ju = numpy.nonzero(numpy.triu(sym, k=1))
    for i, j in zip(iu.tolist(), ju.tolist()):
        u, v = ids[i], ids[j]
        pe[(min(u, v), max(u, v))] = int(sym[i, j])
    for i in numpy.nonzero(numpy.diagonal(total))[0].tolist():
        pe[(ids[i], ids[i])] = int(total[i, i])
    return pe, PEInfo(pe)


def run_sample(gfa_file: str, path_file: str, reads: pe_links.Reads,
               out: str, device, min_len: int = 250,
               logger: logging.Logger = None, key_bits: int = None):
    """Stages 1-9 of a sample; returns (ids, links). With `key_bits`
    (the control) windows match by that many bits of a hash of the
    k-mer (`pe_links.KmerIndex`), and the later stages read those links."""
    logger = logger or _LOG
    for sub in ("gfa", "tmp", "paf", "aln"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    view = load_gfa_canonized(gfa_file, logger)
    write_gfa(view, f"{out}/gfa/graph_L0.gfa", logger)
    view0 = view.compact()
    view0, idx_mapping = reindexing(view0)
    write_gfa(view0, f"{out}/gfa/graph_L0r.gfa", logger)

    dps = [v.dp for v in view0.graph.vertices()]
    threshold = threshold_estimation(numpy.array(dps), logger)
    contig_dict, contig_info = spades_paths_parser(
        view0, idx_mapping, path_file, min_len, threshold, logger)
    copy_contig_dict = {cno: [list(contig), clen, ccov]
                        for cno, [contig, clen, ccov] in contig_dict.items()}
    contig_dict_to_path(contig_dict, f"{out}/tmp/init_contigs.paths")
    contig_dict_to_fasta(view0, contig_dict, f"{out}/tmp/init_contigs.fasta")

    graph_simplification(view0, None, threshold, logger)
    write_gfa(view0, f"{out}/gfa/s_graph_L1.gfa", logger)
    view1 = view0.compact()
    for cno, [contig, _, _] in list(contig_dict.items()):
        if any(c not in view1.nodes for c in contig):
            contig_dict.pop(cno)
    ksize = next(iter(view1.edges.values())).overlap

    ids = list(view1.nodes.keys())
    links = pe_links.pe_links([view1.nodes[i].seq for i in ids], reads,
                              ksize, device, key_bits=key_bits)
    pe_info, dcpy_pe_info = pe_info_from_links(
        ids, links.node_mat.cpu().numpy(), links.short_mat.cpu().numpy())

    edge_cleaning(view1, contig_dict, pe_info, logger)
    view2 = store_reinit_graph(view1, f"{out}/gfa/es_graph_L2.gfa", logger)
    contig_dict_to_path(contig_dict, f"{out}/tmp/pre_contigs.paths")
    contig_dict_to_fasta(view2, contig_dict, f"{out}/tmp/pre_contigs.fasta")

    delta = 0.05 * float(numpy.median([v.dp for v in view2.graph.vertices()]))
    viewf = iter_graph_disentanglement(view2, contig_dict, pe_info, delta,
                                       out, logger)
    contig_dict_to_path(contig_dict, f"{out}/tmp/post_contigs.paths")
    contig_dict_to_fasta(viewf, contig_dict, f"{out}/tmp/post_contigs.fasta")
    write_gfa(viewf, f"{out}/gfa/ckpt_disentangled.gfa")

    full_link = best_matching(viewf, contig_dict, pe_info, logger)
    increment_nt_branch_coverage(viewf, logger)
    write_gfa(viewf, f"{out}/gfa/split_graph_final.gfa", logger)
    p_delta = 0.05 * float(numpy.median([v.dp for v in viewf.graph.vertices()]))
    strain_dict, _, viewf = path_extension(viewf, contig_dict, full_link,
                                           dcpy_pe_info, p_delta, out,
                                           logger)

    contig_resolve(strain_dict)
    viewl = load_flipped_gfa(f"{out}/gfa/es_graph_L2.gfa", logger)
    trim_contig_dict(viewl, strain_dict, logger)
    contig_dup_removed_s(strain_dict, logger)
    contig_dict_to_path(strain_dict, f"{out}/tmp/tmp_strain.paths", None,
                        False)
    strain_repeat_resol(view0, strain_dict, contig_info, copy_contig_dict,
                        logger)
    contig_dict_to_fasta(view0, strain_dict, f"{out}/strain.fasta")
    contig_dict_to_path(strain_dict, f"{out}/strain.paths", idx_mapping,
                        True)
    return ids, links
