"""Multi-host (multi-process) scaling over torch.distributed — the PyTorch
port of `vstrains_tpu/parallel/distributed.py`.

  * every process runs the same program in one torch.distributed world
    (address, size and rank from the arguments or torchrun's environment:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
  * the graph and k-mer table are replicated per process (they are tiny:
    viral genomes);
  * each process loads a disjoint stripe of the read pairs (contiguous
    blocks by rank; integer accumulation is order-free, so no read
    shuffling is needed);
  * a process drives one device, so its engine is the single-GPU engine
    (ops.pe_infer.infer_pe_links) on its stripe; one all-reduce (or COO
    gather) at the end merges every process's links, bit-identical to
    the serial loop. The dense/sparse route is taken from the batch size
    and the graph alone, so every process takes the same one.

The int64 link matrices and COO arrays travel as int64: NCCL and gloo
reduce int64, so the JAX package's (low31, high) int32 halves, there
only because TPU arrays have no int64, are gone (a deliberate
difference). So is the JAX drivers' `model` argument: a process here
drives one device, and a table sharded over ranks is
parallel.mesh.infer_pe_links_sharded's. A single-process run is the
single-GPU engine's.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from vstrains_tpu_torch.core.fastq import ReadPairBatch, load_read_pairs
from vstrains_tpu_torch.device import resolve_device
from vstrains_tpu_torch.ops.pe_infer import (PEResult, PESparseResult,
                                             _empty_result, _is_sparse,
                                             infer_pe_links)
from vstrains_tpu_torch.parallel.collectives import all_reduce, world_size
from vstrains_tpu_torch.parallel.mesh import merge_coo_ranks

_LOG = logging.getLogger(__name__)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     logger: logging.Logger = None, device="cuda",
                     backend: Optional[str] = None) -> int:
    """Join this process to a torch.distributed world; a no-op for a
    single-process run (no address and at most one process). Returns the
    rank.

    The arguments default to torchrun's environment: MASTER_ADDR and
    MASTER_PORT ("host:port"; an address with "://", such as a file://
    store, is used as it is), WORLD_SIZE and RANK. The backend follows
    `device`: "nccl" for cuda, "gloo" for cpu; a caller may pass
    backend="gloo" with a cuda device (ranks that share one card). A cuda
    rank binds its card first: the index `device` names, else
    cuda:LOCAL_RANK."""
    logger = logger or _LOG
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not (coordinator_address or (num_processes or 1) > 1):
        return 0
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes or 1,
                            rank=process_id or 0)
    logger.info("torch.distributed: rank %d/%d, backend %s, device %s",
                dist.get_rank(), dist.get_world_size(), backend, dev)
    return dist.get_rank()


def host_read_stripe(fwd_path: str, rve_path: str, split_len: int,
                     process_id: int, process_count: int) -> ReadPairBatch:
    """This host's contiguous stripe of the usable read pairs.

    Loading happens host-side then slicing by stripe; for truly huge
    FASTQs, pre-split the files per host and pass per-host paths instead.
    """
    batch = load_read_pairs(fwd_path, rve_path, split_len)
    n = batch.num_pairs
    per = -(-n // process_count)
    lo = min(process_id * per, n)
    hi = min(lo + per, n)
    return ReadPairBatch(
        batch.fwd_codes[lo:hi], batch.fwd_len[lo:hi],
        batch.rve_codes[lo:hi], batch.rve_len[lo:hi],
        batch.n_reads, batch.short_reads, hi - lo)


def infer_pe_links_multihost(ids: Sequence[str], seqs: Sequence[str],
                             local_reads: ReadPairBatch, kmer_size: int,
                             batch_size: int = 16384,
                             logger: logging.Logger = None, *,
                             device, stats_mode: str = "auto"):
    """PE-link inference over every process of the world, on `device`
    (this process's card, or "cpu").

    `local_reads` is this process's stripe. Its links come from the
    single-GPU engine and are then summed over the world (integer sums,
    order-free); every process returns the merged result. Past the
    dense/sparse cutover (dense_budget_rows, or stats_mode="sparse") the
    engine is the sparse COO engine, and the COO chunks are merged
    instead (a PESparseResult)."""
    logger = logger or _LOG
    sparse = _is_sparse(stats_mode, batch_size, len(seqs))
    local = infer_pe_links(ids, seqs, local_reads, kmer_size,
                           batch_size=batch_size,
                           stats_mode="sparse" if sparse else "dense",
                           logger=logger, device=device)
    if sparse and isinstance(local, PEResult):
        # an empty stripe (or table): the engine's all-zero matrices
        local = _empty_result(ids, local_reads, 0, sparse=True)
    if world_size() == 1:
        return local
    backend = dist.get_backend()
    if sparse:
        coo = merge_coo_ranks((local.pair_keys, local.pair_counts,
                               local.short_keys, local.short_counts),
                              backend, device)
        return PESparseResult(list(ids), *coo, local.n_reads,
                              local.short_reads, local.used_reads)
    comm = resolve_device(device) if backend == "nccl" else "cpu"
    node_mat, short_mat = (
        all_reduce(torch.from_numpy(m).to(comm), dist.ReduceOp.SUM, None,
                   backend).cpu().numpy()
        for m in (local.node_mat, local.short_mat))
    return PEResult(list(ids), node_mat, short_mat, local.n_reads,
                    local.short_reads, local.used_reads)


def infer_pe_links_sparse_multihost(ids: Sequence[str],
                                    seqs: Sequence[str],
                                    local_reads: ReadPairBatch,
                                    kmer_size: int, batch_size: int = 8192,
                                    logger: logging.Logger = None, *,
                                    device) -> PESparseResult:
    """Explicit multi-process large-N path: the sparse COO engine on this
    process's stripe, on `device`, per-process COO chunks merged over the
    world."""
    return infer_pe_links_multihost(ids, seqs, local_reads, kmer_size,
                                    batch_size=batch_size, logger=logger,
                                    device=device, stats_mode="sparse")
