"""One run of one benchmark cell of `vstrains_tpu_torch` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the cell's dataset (generated on a checkout's first run),
builds the traffic's loop and runs its warm-up; the window then
runs steps until `--seconds` have passed, finishing the step under way.
After the window: the peak device memory, the program's state freed,
the check of the kept outputs against the reference, the metrics (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones from a
profiler trace of the window), and one JSON line on stdout, the last.
Without a CUDA card with as many devices as the cell asks for, it exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

_T_ENTER = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from portbench import check, data, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vstrains_tpu")


def process_start() -> float:
    """The host clock when this process started (Linux), else when this
    module began to run."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_ENTER


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """What a loop is given: the cell, its data, the seed's generator."""
    cell: str
    config: dict
    traffic: dict
    paths: Dict[str, str]
    device: torch.device
    seed: int
    rng: object
    tmp: str
    log: object = log
    work: Dict[str, int] = field(default_factory=dict)


@dataclass
class Run:
    """What the metric readers read: each reader takes the fields it
    needs and returns None where they are absent."""
    setup_s: float
    window_s: float
    records: List[dict]
    trace: Optional[trace.Summary]
    work: Dict[str, int]


class Keep:
    """The window's last step and one earlier step drawn from the seed
    (a reservoir of one); `dispose` gets every other step."""

    def __init__(self, rng, dispose):
        self.rng, self.dispose = rng, dispose
        self.pick = self.last = None
        self.seen = 0

    def add(self, rec):
        if self.last is not None:
            self.seen += 1
            if self.rng.random() < 1.0 / self.seen:
                if self.pick is not None:
                    self.dispose(self.pick)
                self.pick = self.last
            else:
                self.dispose(self.last)
        self.last = rec

    def kept(self):
        return [r for r in (self.pick, self.last) if r is not None]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card(device: torch.device) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    return out


def host_use():
    """This process's CPU seconds (user, system) and context switches
    (voluntary, involuntary) so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return (ru.ru_utime, ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw)


def host_line(before, after, wall: float) -> str:
    """How the process used the host in `wall` seconds: CPU time over the
    wall time shows a host that ran it less than it asked for."""
    d = [b - a for a, b in zip(before, after)]
    return (f"CPU {d[0]:.2f} s user + {d[1]:.2f} s system in {wall:.2f} s "
            f"({100.0 * (d[0] + d[1]) / wall:.1f}% of one core); context "
            f"switches {d[2]} voluntary, {d[3]} involuntary")


def power_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(cell: spec.Cell, seed: int, seconds: float, tracing: bool,
             device: torch.device, t_start: float) -> dict:
    """One run; returns the result line's object."""
    tmp = os.path.join(tempfile.gettempdir(), "portbench", cell.name)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        return _run(cell, seed, seconds, tracing, device, t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, tracing, device, t_start, tmp) -> dict:
    cfg = cell.config
    paths = data.dataset(cfg["name"], cfg["dataset"], seed, log)
    ctx = Ctx(cell.name, cfg, cell.traffic, paths, device, seed,
              data.rng(seed), tmp)
    loop_name = cell.traffic["loop"]
    loop = importlib.import_module(f"portbench.loops.{loop_name}").Loop(ctx)
    t0 = time.perf_counter()
    loop.warm_up()
    log(f"warm-up: {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start

    keep = Keep(data.rng(seed + 1), loop.dispose)
    records = []
    use0 = host_use()
    with trace.traced(tracing, os.path.join(tmp, "trace.json"),
                      device.type == "cuda") as win:
        with trace.span_window(win):
            t0 = time.perf_counter()
            while True:
                t1 = time.perf_counter()
                try:
                    with record_function(trace.STEP):
                        rec = loop.step(win)
                    keep.add(rec)
                except Exception:  # counted as failed; the window goes on
                    traceback.print_exc()
                    rec = {"seconds": time.perf_counter() - t1,
                           "failed": True}
                records.append(rec)
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    log(f"host in the window: {host_line(use0, host_use(), window_s)}")
    dev_info = card(device)
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(1 for r in records if r["failed"])
    secs = sorted(r["seconds"] for r in records)
    log(f"window: {len(records)} steps in {window_s:.3f} s, {failed} failed;"
        f" step seconds min {secs[0]:.4f} median {secs[len(secs) // 2]:.4f}"
        f" p95 {secs[math.ceil(0.95 * len(secs)) - 1]:.4f} max {secs[-1]:.4f}")

    t0 = time.perf_counter()
    checks = loop.check(keep.kept())
    log(f"reference and comparison: {time.perf_counter() - t0:.1f} s, "
        f"{len(keep.kept())} steps checked; work {ctx.work}")

    run = Run(setup_s, window_s, records, win.summary, ctx.work)
    metrics = {}
    for m in (cell.per_layer if tracing else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if tracing and win.summary is not None:
        dev_info["busy_s"] = win.summary.busy_s
        dev_info["window_s"] = win.summary.window_s
    checks, within = check.verdict(checks, loop.LIMITS)
    correct = failed == 0 and bool(records) and within
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": dev_info}
    if tracing and win.summary is not None:
        out["breakdown"] = {"device_ops": win.summary.device_ops,
                            "idle_gaps": win.summary.idle_gaps}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    device = torch.device("cuda", 0)
    importlib.import_module("vstrains_tpu_torch")  # the system under test
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the port must not use: {bad}; no result")
        return 3
    log(f"card: {power_line()}")
    try:
        with open("/proc/self/io") as fh:
            io = dict(line.split(": ") for line in fh.read().splitlines())
        log(f"bytes this process passed to write(): {io['wchar']}")
    except (OSError, KeyError, ValueError):
        pass
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
