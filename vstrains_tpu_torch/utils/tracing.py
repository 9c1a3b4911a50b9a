"""Stage timing, and the port's spans and counters.

Every pipeline stage runs under a StageTimer that records its wall time
(on CUDA after a device synchronize, so a stage's time includes the
device work it queued) inside a span named after the stage, and the
summary is dumped as JSON (<out>/timings.json).

`span(name)` and `count(name, n)` are the program's own instrumentation,
always on and held in one registry:

  * with no torch profiler running, a span reads the host clock twice and
    adds the difference to its name's total, and a count adds to its
    name's total (`totals()`); nothing else is recorded;
  * while a torch profiler runs (`torch.autograd._profiler_enabled()`),
    a span also enters `record_function(name)`, so it lands in the
    profiler's trace, and is kept as (name, start_ns, dur_ns, thread) in
    a bounded list, start_ns on `time.time_ns()`: the clock of the
    trace's `baseTimeNanoseconds + 1000 * ts`; a count also adds to a
    profiled total. `profiled()` returns what was recorded so.

A span never synchronizes the device: it times the host, which waits on
the device only where the code inside it does. The kernel launch
counters of `ops/cuda_kernels.py` are counter groups of the same
registry (`counter_group`).
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.profiler import record_function

_LOG = logging.getLogger(__name__)

_profiler_on = torch.autograd._profiler_enabled
_clock_ns = time.perf_counter_ns

# always on: span name -> host nanoseconds, counter name -> total; every
# update of the registry holds _LOCK (spans close on several threads)
_LOCK = threading.Lock()
_SPAN_NS: Dict[str, int] = {}
_COUNTS: Dict[str, int] = {}
# counter groups owned by other modules (cuda_kernels.LAUNCHES, ...)
_GROUPS: Dict[str, dict] = {}
# while a profiler runs: spans (name, start_ns, dur_ns, thread), at most
# _MAX_PROFILED_SPANS of them (later ones only add to the totals and to
# the count of dropped spans), and the profiled totals
_MAX_PROFILED_SPANS = 1 << 18
_PROFILED_SPANS: List[tuple] = []
_PROFILED_SPAN_NS: Dict[str, int] = {}
_PROFILED_COUNTS: Dict[str, int] = {}
_DROPPED = [0]
# each thread's native id, read once (a system call each time otherwise)
_THREAD = threading.local()


def _thread_id() -> int:
    try:
        return _THREAD.native_id
    except AttributeError:
        _THREAD.native_id = threading.get_native_id()
        return _THREAD.native_id


class span:
    """Context manager timing the enclosed host code under `name`."""
    __slots__ = ("name", "t0", "wall0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the profiler's range opens and closes inside the timed interval,
        # so a span's seconds include what its range costs the host
        self.rf = None
        self.t0 = _clock_ns()
        if _profiler_on():
            self.wall0 = time.time_ns()
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dt = _clock_ns() - self.t0
        name = self.name
        with _LOCK:
            _SPAN_NS[name] = _SPAN_NS.get(name, 0) + dt
            if self.rf is None:
                return False
            _PROFILED_SPAN_NS[name] = _PROFILED_SPAN_NS.get(name, 0) + dt
            if len(_PROFILED_SPANS) < _MAX_PROFILED_SPANS:
                _PROFILED_SPANS.append((name, self.wall0, dt, _thread_id()))
            else:
                _DROPPED[0] += 1
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (and to its profiled total while a
    profiler runs)."""
    on = _profiler_on()
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        if on:
            _PROFILED_COUNTS[name] = _PROFILED_COUNTS.get(name, 0) + n


def counter_group(name: str, initial: dict = None) -> dict:
    """The registry's counter group `name`, a dict its owner updates in
    place (created with `initial` on first use)."""
    if name not in _GROUPS:
        _GROUPS[name] = dict(initial or {})
    return _GROUPS[name]


def totals() -> dict:
    """A copy of the always-on totals: "span_ns" and "counters" by name,
    and each counter group under its own name."""
    with _LOCK:
        out = {"span_ns": dict(_SPAN_NS), "counters": dict(_COUNTS)}
    out.update((g, dict(d)) for g, d in _GROUPS.items())
    return out


def profiled() -> dict:
    """What was recorded while a profiler ran: "spans" [(name, start_ns,
    dur_ns, thread)], "span_ns" and "counters" (totals by name), and
    "dropped" (spans past the list's bound, in the totals only)."""
    with _LOCK:
        return {"spans": list(_PROFILED_SPANS),
                "span_ns": dict(_PROFILED_SPAN_NS),
                "counters": dict(_PROFILED_COUNTS), "dropped": _DROPPED[0]}


def since(before: dict) -> str:
    """One line of what the always-on totals gained since `before` (a
    `totals()`): span seconds, then counters, then each counter group. A
    counter first named since `before` is printed even at 0."""
    now = totals()
    parts = []
    for key, fmt in (("span_ns", lambda v: f"{v * 1e-9:.4f} s"),
                     ("counters", str)):
        gained = {k: v - before[key].get(k, 0) for k, v in now[key].items()}
        items = [f"{k} {fmt(v)}" for k, v in sorted(gained.items())
                 if v > 0 or (key == "counters" and k not in before[key])]
        parts.append(", ".join(items) or "none")
    for g in _GROUPS:
        gained = {k: v - before.get(g, {}).get(k, 0)
                  for k, v in now[g].items()}
        items = [f"{k} {v}" for k, v in gained.items() if v > 0]
        if items:
            parts.append(f"{g} " + ", ".join(items))
    return "; ".join(parts)


@dataclass
class StageTimer:
    """Accumulates named stage durations for one run on `device`."""
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    stages: List[dict] = field(default_factory=list)

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    @contextlib.contextmanager
    def stage(self, name: str, logger: logging.Logger = None):
        logger = logger or _LOG
        t0 = time.time()
        with span(name):
            yield
            if self._cuda():
                torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        self.stages.append({"stage": name, "seconds": round(dt, 4)})
        logger.info("[timing] %s: %.2fs", name, dt)

    def summary(self) -> Dict:
        total = sum(s["seconds"] for s in self.stages)
        return {"total_seconds": round(total, 4), "stages": self.stages}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

