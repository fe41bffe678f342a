"""Profiling and tracing: per-phase wall clock and a device trace.

Counterpart of mofa_tpu/utils/profiling.py:

- `trace(logdir)`: a `torch.profiler` trace (host and CUDA activity) of
  the block, written to `logdir` as a Chrome trace (chrome://tracing or
  Perfetto);
- `PhaseTimer`: wall-clock seconds per named phase, synchronising the CUDA
  device at each phase's end so that queued work is counted where it runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class PhaseTimer:
    """Accumulates wall seconds per phase; with a CUDA `device`, each phase
    ends with `torch.cuda.synchronize(device)`."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        return "\n".join(f"{name:30s} {self.totals[name]:9.3f}s x{self.counts[name]}"
                         for name in sorted(self.totals, key=self.totals.get,
                                            reverse=True))
