"""Batched numeric graph passes (with exact host mirrors), in torch.

Port of `vstrains_tpu/ops/graph_ops.py`:

  * edge-flow assignment (reference: VStrains_Utilities.py:14-31) — two
    `index_add_` segment sums and one fused elementwise pass over all
    edges, in float32 on the chosen device;
  * coverage-threshold histogram (reference: VStrains_Preprocess.py:37-70),
    host numpy as before;
  * DAG check as iterative source elimination (Kahn) over the dense edge
    list, `index_add_` in-degrees until the live set stops changing — the
    device analogue of the reference's recursive DFS (Utilities:1158-1202,
    `algos/dag.graph_is_DAG` on the host); no pipeline stage calls it.

Graphs here are small (10^2..10^4 nodes), so `assign_edge_flow` keeps the
exact float64 host path below 20,000 edges and uses the device pass above
it. The device pass's sums run in another order than the JAX package's
`segment_sum`, so the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vstrains_tpu_torch.core.graph import GraphTensors, GraphView
from vstrains_tpu_torch.device import resolve_device, run_device

_DEVICE_EDGE_CUTOFF = 20_000


def _edge_flow(dp: torch.Tensor, edge_src: torch.Tensor,
               edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """flow(u,v) = mean(dp[v]/out_sum(u) * dp[u], dp[u]/in_sum(v) * dp[v])."""
    du = dp[edge_src]
    dv = dp[edge_dst]
    out_sum = torch.zeros(num_nodes, dtype=dp.dtype,
                          device=dp.device).index_add_(0, edge_src, dv)
    in_sum = torch.zeros(num_nodes, dtype=dp.dtype,
                         device=dp.device).index_add_(0, edge_dst, du)
    return 0.5 * (dv / out_sum[edge_src] * du + du / in_sum[edge_dst] * dv)


def edge_flow_device(t: GraphTensors, device="cuda") -> np.ndarray:
    """Device path: all edge flows in one pass (float32) on `device`
    ("cuda" raises without a card; "cpu" for the host)."""
    if t.num_edges == 0:
        return np.zeros(0, dtype=np.float32)
    dev = resolve_device(device)
    flows = _edge_flow(
        torch.as_tensor(t.dp, dtype=torch.float32, device=dev),
        torch.as_tensor(t.edge_src, dtype=torch.int64, device=dev),
        torch.as_tensor(t.edge_dst, dtype=torch.int64, device=dev),
        t.num_nodes)
    return flows.cpu().numpy()


def assign_edge_flow(view: GraphView, exact: Optional[bool] = None,
                     device=None) -> None:
    """Write coverage-proportional flow onto every live edge.

    Parity: VStrains_Utilities.py:14-31. exact=None auto-selects host
    float64 for small graphs, device segment-sums for large ones. The
    device pass runs on `device`; None means the run's device as the
    pipeline set it (`device.run_on`; the graph reloads in core/gfa.py call
    this without one), and "cuda" outside a run.
    """
    if exact is None:
        exact = view.num_edges() < _DEVICE_EDGE_CUTOFF
    if exact:
        for (u, v), e in view.edges.items():
            u_node = view.nodes[u]
            v_node = view.nodes[v]
            u_out_sum = float(np.sum([n.dp for n in u_node.out_neighbors()]))
            v_in_sum = float(np.sum([n.dp for n in v_node.in_neighbors()]))
            e.flow = float(np.mean([
                (v_node.dp / u_out_sum) * u_node.dp,
                (u_node.dp / v_in_sum) * v_node.dp,
            ]))
    else:
        t = view.tensors()
        flows = edge_flow_device(t, run_device() if device is None
                                 else device)
        for e, f in zip(view.edges.values(), flows):
            e.flow = float(f)


def save_coverage_plot(dps: np.ndarray, threshold: float,
                       out_path: str) -> bool:
    """Coverage histogram plot with the chosen cutoff (parity:
    VStrains_Preprocess.py:62-69). Optional: returns False when matplotlib
    is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    dps = np.asarray(dps, dtype=np.float64)
    plt.figure(figsize=(16, 8))
    plt.hist(x=dps, bins=min(len(dps), 200))
    plt.axvline(threshold, color="r")
    plt.title("node depth histogram")
    plt.xlabel("depth")
    plt.ylabel("nodes")
    plt.savefig(out_path)
    plt.close()
    return True


def threshold_estimation(dps: np.ndarray, logger=None) -> float:
    """Histogram-based low-coverage cutoff (VStrains_Preprocess.py:37-70).

    If the global histogram peak falls in the lowest bin, the cutoff ratio
    grows by 0.05 per strictly-descending bin (max 4 steps); threshold =
    ratio * median.
    """
    dps = np.asarray(dps, dtype=np.float64)
    if dps.size == 0 or dps.max() == dps.min():
        return 0.00
    med = np.median(dps)
    nbins = int((dps.max() - dps.min()) // (0.05 * med))
    if nbins <= 0:
        return 0.00
    regions, _bins = np.histogram(dps, bins=nbins)
    pidx = int(np.argmax(regions))  # first max
    ratio = 0.00
    if pidx == 0:
        ratio = 0.05
        for i in range(0, 4):
            if i >= len(regions):
                if logger:
                    logger.warning("histogram is not properly set, reset "
                                   "cutoff to default (0.05*M)")
                ratio = 0.05
                break
            if i + 1 >= len(regions):
                break
            if regions[i] > regions[i + 1]:
                ratio += 0.05
            else:
                break
    return float(ratio * med)


def graph_is_dag_device(t: GraphTensors, device="cuda") -> bool:
    """True iff the graph of `t` has no cycle, by iterative source
    elimination on `device`: each round keeps the nodes that still have
    a live in-edge and the edges whose source survived, until the live
    set stops changing; a DAG empties it. The JAX package's
    `_dag_check_kernel` (a `while_loop` over `segment_sum` in-degrees)."""
    if t.num_edges == 0:
        return True
    dev = resolve_device(device)
    src = torch.as_tensor(t.edge_src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(t.edge_dst, dtype=torch.int64, device=dev)
    live = torch.ones(t.num_nodes, dtype=torch.bool, device=dev)
    edge_live = live[src] & live[dst]
    while True:
        indeg = torch.zeros(t.num_nodes, dtype=torch.int32,
                            device=dev).index_add_(0, dst,
                                                   edge_live.to(torch.int32))
        new_live = live & (indeg > 0)
        edge_live = edge_live & new_live[src]
        changed = bool((new_live != live).any())
        live = new_live
        if not changed:
            return not bool(live.any())
