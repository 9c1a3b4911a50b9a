"""One rank of a torch.distributed world on the CPU (gloo), for
tests/test_torch_parallel.py.

Usage: python torch_dist_worker.py <init_method> <world> <rank> <jobs.json>

Joins the world through `parallel.distributed.init_distributed` on
device "cpu", runs every job of the JSON list in order (all ranks run
the same list, so their collectives line up) and writes each job's
result as `<out>.r<rank>.npz`. Imports only the port, never JAX.
"""

import json
import os
import sys


def _reads(npz):
    from vstrains_tpu_torch.core.fastq import ReadPairBatch
    return ReadPairBatch(npz["fc"], npz["fl"], npz["rc"], npz["rl"],
                         int(npz["n_reads"]), int(npz["short_reads"]),
                         int(npz["fl"].shape[0]))


def _result_arrays(res) -> dict:
    from vstrains_tpu_torch.ops.pe_infer import PESparseResult
    if isinstance(res, PESparseResult):
        return dict(kind="sparse", pair_keys=res.pair_keys,
                    pair_counts=res.pair_counts, short_keys=res.short_keys,
                    short_counts=res.short_counts)
    return dict(kind="dense", node_mat=res.node_mat,
                short_mat=res.short_mat)


def run_job(job: dict, rank: int, world: int) -> dict:
    import numpy as np

    from vstrains_tpu_torch.parallel import distributed as D
    from vstrains_tpu_torch.parallel import mesh as M

    kind = job["kind"]
    if kind in ("sharded", "sparse_sharded"):
        npz = np.load(job["inputs"])
        refs = [str(x) for x in npz["refs"]]
        ids = [str(i) for i in range(len(refs))]
        mesh = M.make_mesh(job["data"], job["model"], device="cpu")
        if kind == "sharded":
            res = M.infer_pe_links_sharded(
                ids, refs, _reads(npz), int(npz["k"]), mesh,
                batch_size=job["batch_size"],
                stats_mode=job.get("stats_mode", "auto"))
        else:
            from vstrains_tpu_torch.utils import tracing
            before = tracing.totals()["counters"]
            res = M.infer_pe_links_sparse_sharded(
                ids, refs, _reads(npz), int(npz["k"]), mesh,
                batch_size=job["batch_size"], cap=job.get("cap", 16),
                cap_c=job.get("cap_c"), coo_slots=job.get("coo_slots"))
            grows = (tracing.totals()["counters"]["pe.coo_table_grows"]
                     - before.get("pe.coo_table_grows", 0))
            return dict(_result_arrays(res), coo_table_grows=grows)
        return _result_arrays(res)
    if kind == "multihost":
        ids, seqs = [], []
        with open(os.path.join(job["data"],
                               "assembly_graph_after_simplification.gfa")) \
                as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f[0] == "S":
                    ids.append(f[1])
                    seqs.append(f[2])
        k = job["k"]
        stripe = D.host_read_stripe(
            os.path.join(job["data"], "reads_1.fastq"),
            os.path.join(job["data"], "reads_2.fastq"), k + 1, rank, world)
        dense = D.infer_pe_links_multihost(ids, seqs, stripe, k,
                                           batch_size=job["batch_size"],
                                           device="cpu")
        sparse = D.infer_pe_links_sparse_multihost(
            ids, seqs, stripe, k, batch_size=job["batch_size"],
            device="cpu")
        out = {"stripe_pairs": np.int64(stripe.num_pairs)}
        out.update(node_mat=dense.node_mat, short_mat=dense.short_mat)
        for f in ("pair_keys", "pair_counts", "short_keys", "short_counts"):
            out[f] = getattr(sparse, f)
        return out
    if kind == "sp":
        from vstrains_tpu_torch.core.seq import encode_seq
        npz = np.load(job["inputs"])
        mesh = M.make_mesh(model=1, device="cpu")
        h1, h2, valid = M.sp_window_hashes(encode_seq(str(npz["seq"])),
                                           int(npz["L"]), mesh)
        tab = M.build_table_auto([str(x) for x in npz["seqs"]],
                               int(npz["table_L"]), "cpu")
        return dict(h1=h1, h2=h2, valid=valid, tab_h1=tab.h1_biased,
                    tab_h2=tab.h2, tab_node=tab.node, tab_offset=tab.offset,
                    tab_max_dup=np.int64(tab.max_dup))
    if kind == "per_component":
        from vstrains_tpu_torch import cli
        data = job["data"]
        rc = cli.main([
            "-a", "spades",
            "-g", os.path.join(data,
                               "assembly_graph_after_simplification.gfa"),
            "-p", os.path.join(data, "contigs.paths"),
            "-fwd", os.path.join(data, "reads_1.fastq"),
            "-rve", os.path.join(data, "reads_2.fastq"),
            "-o", f"{job['out']}.r{rank}",
            "--pe-batch-size", str(job["batch_size"]), "--per-component",
            "--device", "cpu"])
        return dict(rc=np.int64(rc))
    raise ValueError(f"unknown job kind {kind!r}")


def main() -> int:
    init, world, rank, jobs_path = sys.argv[1:5]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from vstrains_tpu_torch.parallel.distributed import init_distributed
    world, rank = int(world), int(rank)
    assert init_distributed(init, world, rank, device="cpu") == rank
    with open(jobs_path) as fh:
        jobs = json.load(fh)
    for job in jobs:
        np.savez(f"{job['out']}.r{rank}.npz", **run_job(job, rank, world))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
