"""Stage timing + device profiling.

Every pipeline stage runs under a StageTimer that records its wall time
(on CUDA after a device synchronize, so a stage's time includes the
device work it queued) inside an NVTX range named after the stage, and
the summary is dumped as JSON (<out>/timings.json). With a profile
directory, `device_trace()` records a torch.profiler trace of the
enclosed region (CPU and CUDA activity) as a Chrome trace file there.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

_LOG = logging.getLogger(__name__)


@dataclass
class StageTimer:
    """Accumulates named stage durations for one run on `device`."""
    profile_dir: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    stages: List[dict] = field(default_factory=list)

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    @contextlib.contextmanager
    def stage(self, name: str, logger: logging.Logger = None):
        logger = logger or _LOG
        t0 = time.time()
        ctx = (torch.cuda.nvtx.range(name) if self._cuda()
               else contextlib.nullcontext())
        with ctx:
            yield
            if self._cuda():
                torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        self.stages.append({"stage": name, "seconds": round(dt, 4)})
        logger.info("[timing] %s: %.2fs", name, dt)

    @contextlib.contextmanager
    def device_trace(self, name: str):
        """torch.profiler trace of the enclosed region, written to
        <profile_dir>/<name>.trace.json (view in chrome://tracing or
        Perfetto). A no-op without a profile directory."""
        if not self.profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._cuda():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"{name}.trace.json"))

    def summary(self) -> Dict:
        total = sum(s["seconds"] for s in self.stages)
        return {"total_seconds": round(total, 4), "stages": self.stages}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
