"""What the program reports of itself in the traced window: the spans
and counters that `vstrains_tpu_torch.utils.tracing` recorded while the
window's profiler ran (`profiled()`), as means over the window's engine
passes. A program without that registry gives nothing to read."""

from __future__ import annotations

from typing import Optional


def _profiled() -> Optional[dict]:
    try:
        from vstrains_tpu_torch.utils.tracing import profiled
    except ImportError:
        return None
    got = profiled()
    return got if got["span_ns"] else None


def _passes(run) -> int:
    return sum(1 for r in run.records if "pairs" in r)


def span_s(run, name: str) -> Optional[float]:
    """Mean seconds a pass spent in the span `name`."""
    n = _passes(run)
    got = _profiled() if n else None
    if got is None or name not in got["span_ns"]:
        return None
    return got["span_ns"][name] * 1e-9 / n


def counter(run, name: str, scale: float = 1.0) -> Optional[float]:
    """Mean of the counter `name` a pass, times `scale`."""
    n = _passes(run)
    got = _profiled() if n else None
    if got is None or name not in got["counters"]:
        return None
    return got["counters"][name] * scale / n
