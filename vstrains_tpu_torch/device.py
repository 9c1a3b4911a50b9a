"""The port's device choice: explicit, never a silent CPU fallback."""

from __future__ import annotations

import contextlib
import contextvars

import torch

# the device of the pipeline run in progress (run_on), or None outside one
_RUN_DEVICE = contextvars.ContextVar("vstrains_run_device", default=None)


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


@contextlib.contextmanager
def run_on(device: torch.device):
    """A run's device for the code inside: torch's default device, and
    what `run_device()` answers, so that code called without a device (the
    graph reloads inside the algorithms) works on the run's device."""
    token = _RUN_DEVICE.set(device)
    try:
        with torch.device(device):
            yield device
    finally:
        _RUN_DEVICE.reset(token)


def run_device():
    """The device of the enclosing `run_on`, else "cuda" (so code called
    outside a run needs a card, as every entry point does)."""
    dev = _RUN_DEVICE.get()
    return "cuda" if dev is None else dev
