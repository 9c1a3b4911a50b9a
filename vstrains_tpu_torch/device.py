"""The port's device choice: explicit, never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """Turn a device name ("cuda", "cuda:1", "cpu") or a torch.device into
    a torch.device. A CUDA device must exist: without one this raises
    instead of falling back to the CPU, so a run that asked for the GPU
    never quietly measures the host."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available "
                "(pass --device cpu to run the plain PyTorch path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev
