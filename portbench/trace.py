"""The traced window: a torch.profiler trace (host and device) around the
measured loop, reduced to the device's busy time, the busy time inside
each step, the device operations that took most time and the idle time
by what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

WINDOW = "portbench.window"
STEP = "portbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float
    step_busy_s: List[float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


@dataclass
class Window:
    """Host clock of the window's start and its host-side marks
    ((start, end, name) in `time.time()` seconds), which name idle time
    where no host span of the trace does."""
    host_start: float = 0.0
    marks: List[Tuple[float, float, str]] = field(default_factory=list)
    summary: Optional[Summary] = None


@contextlib.contextmanager
def traced(enabled: bool, path: str, cuda: bool):
    """Profile the enclosed window when `enabled`; the window itself is
    opened by `span_window`. Leaves the reduced trace in `.summary`."""
    win = Window()
    if not enabled:
        yield win
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield win
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    win.summary = reduce_trace(events, win)


@contextlib.contextmanager
def span_window(win: Window):
    with record_function(WINDOW):
        win.host_start = time.time()
        yield


def _merge(iv: List[Tuple[float, float]]):
    iv.sort()
    starts, ends = [], []
    for a, b in iv:
        if starts and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return np.array(starts), np.array(ends)


class _Busy:
    """Union of device intervals, and its length inside any span."""

    def __init__(self, iv):
        self.s, self.e = _merge(iv)
        self.cum = np.concatenate([[0.0], np.cumsum(self.e - self.s)])

    def _upto(self, t: float) -> float:
        i = int(np.searchsorted(self.s, t, side="right"))
        if i == 0:
            return 0.0
        return float(self.cum[i - 1] + min(self.e[i - 1], t) - self.s[i - 1])

    def between(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)

    def gaps(self, a: float, b: float):
        t = a
        for s, e in zip(self.s, self.e):
            if e <= a:
                continue
            if s >= b:
                break
            if s > t:
                yield t, s
            t = max(t, e)
        if t < b:
            yield t, b


def _innermost(spans, starts, t: float) -> Optional[str]:
    """The latest-starting span that covers t (spans sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return None


def reduce_trace(events, win: Window) -> Summary:
    device, host = [], []
    w0 = w1 = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((a, b, ev.get("name", "")))
        elif cat in ("user_annotation", "cpu_op"):
            if ev.get("name") == WINDOW and cat == "user_annotation":
                w0, w1 = a, b
            host.append((a, b, ev.get("name", ""), cat))
    if w0 is None:
        raise RuntimeError("the traced window has no span")
    busy = _Busy([(a, b) for a, b, _ in device])
    by_op: Dict[str, float] = {}
    for a, b, name in device:
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            by_op[name[:120]] = by_op.get(name[:120], 0.0) + (hi - lo) * 1e-6
    steps = [(h[0], h[1]) for h in host if h[2] == STEP]
    step_busy = [busy.between(a, b) * 1e-6 for a, b in steps
                 if a >= w0 and b <= w1]
    # host marks on the trace's clock
    offset = w0 - win.host_start * 1e6
    marks = sorted((a * 1e6 + offset, b * 1e6 + offset, n)
                   for a, b, n in win.marks)
    mark_starts = [m[0] for m in marks]
    spans = sorted(h for h in host
                   if h[3] == "user_annotation" and h[2] not in (WINDOW, STEP))
    ops = sorted(h for h in host if h[3] == "cpu_op")
    span_starts = [h[0] for h in spans]
    op_starts = [h[0] for h in ops]
    cuts = sorted({t for m in marks for t in m[:2]})
    idle: Dict[str, float] = {}
    for a, b in busy.gaps(w0, w1):
        # a gap that spans host marks is named piece by piece
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for x, y in zip([a] + inner, inner + [b]):
            t = 0.5 * (x + y)
            parts = [_innermost(marks, mark_starts, t),
                     _innermost(spans, span_starts, t),
                     _innermost(ops, op_starts, t)]
            label = "/".join(p for p in parts if p) or "host, outside any span"
            idle[label] = idle.get(label, 0.0) + (y - x) * 1e-6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary((w1 - w0) * 1e-6, busy.between(w0, w1) * 1e-6,
                   step_busy, top(by_op), top(idle))
