"""The two graph passes the host stages call, from
`vstrains_tpu_torch/ops/graph_ops.py` at commit
bc5e135ef114cb1be5519b7422aa36d058e4b564: the coverage threshold, and
the edge flow by the program's rule (float64 on the host below 20,000
edges; above it the float32 pass, here in plain torch on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

_DEVICE_EDGE_CUTOFF = 20_000


def _edge_flow(dp: torch.Tensor, edge_src: torch.Tensor,
               edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """flow(u,v) = mean(dp[v]/out_sum(u) * dp[u], dp[u]/in_sum(v) * dp[v])."""
    du = dp[edge_src]
    dv = dp[edge_dst]
    out_sum = torch.zeros(num_nodes, dtype=dp.dtype).index_add_(0, edge_src,
                                                                dv)
    in_sum = torch.zeros(num_nodes, dtype=dp.dtype).index_add_(0, edge_dst,
                                                               du)
    return 0.5 * (dv / out_sum[edge_src] * du + du / in_sum[edge_dst] * dv)


def assign_edge_flow(view, exact=None, device=None) -> None:
    """Write coverage-proportional flow onto every live edge
    (VStrains_Utilities.py:14-31). `device` is accepted for the copied
    callers and ignored: everything here runs on the host."""
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
        return
    t = view.tensors()
    flows = _edge_flow(torch.as_tensor(t.dp, dtype=torch.float32),
                       torch.as_tensor(t.edge_src, dtype=torch.int64),
                       torch.as_tensor(t.edge_dst, dtype=torch.int64),
                       t.num_nodes).numpy()
    for e, f in zip(view.edges.values(), flows):
        e.flow = float(f)


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
