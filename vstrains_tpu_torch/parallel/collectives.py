"""The parallel layer's collectives over torch.distributed, in one place.

Over NCCL they work on the tensors' own CUDA device. Over gloo they stage
through host memory explicitly (gloo has no CUDA all_gather), so the same
engine code runs over NCCL on multi-GPU hosts, over gloo on CPU ranks,
and over gloo on ranks that share one card. Integers travel as int64
where they are int64: both backends reduce int64 (the JAX package split
int64 into int32 halves only because TPU arrays have no int64).

`group` is a process group from `dist.new_group`, or None for the default
(world) group; `backend` is that world's backend ("nccl" or "gloo").
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks of the default process group, 1 when none is initialized
    (the JAX package's jax.process_count())."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def all_reduce(t: torch.Tensor, op, group, backend: str) -> torch.Tensor:
    """Reduce `t` in place over `group` with `op` (dist.ReduceOp); a view
    that is not contiguous reduces through a contiguous copy."""
    h = t.contiguous() if backend == "nccl" else t.cpu().contiguous()
    dist.all_reduce(h, op=op, group=group)
    if h is not t:
        t.copy_(h)
    return t


def all_gather_cat(t: torch.Tensor, group, backend: str,
                   dim: int) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks), concatenated along `dim`
    in rank order, on `t`'s device."""
    src = (t if backend == "nccl" else t.cpu()).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_ragged(arr: np.ndarray, group, backend: str,
                      device) -> List[np.ndarray]:
    """Every rank's 1-D int64 array, of any length, in rank order: the
    lengths first, then the arrays zero-padded to the longest, each cut
    back to its length."""
    dev = torch.device(device) if backend == "nccl" else torch.device("cpu")
    n = dist.get_world_size(group)
    size = torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(x.item()) for x in sizes]
    pad = torch.zeros(max(1, max(sizes)), dtype=torch.int64, device=dev)
    pad[:arr.shape[0]] = torch.from_numpy(np.asarray(arr, np.int64))
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad, group=group)
    return [p[:k].cpu().numpy() for p, k in zip(parts, sizes)]
