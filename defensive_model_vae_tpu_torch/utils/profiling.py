"""Profiling: per-stage wall-clock timers + the torch device profiler hook.

Port of ``defensive_model_vae_tpu/utils/profiling.py``.  A stage timer whose
report is machine-readable, and a context manager that writes a
``torch.profiler`` trace (Chrome trace format, viewable in Perfetto or
``chrome://tracing``) where the JAX package wrote a ``jax.profiler`` one.

CUDA launches return before the device has run them, so a timer given a
CUDA device synchronises it (``torch.cuda.synchronize``) before it reads the
clock at a stage's start and end: a stage's seconds then hold the device
work it queued, as the JAX package's stages did by fetching their results.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional


class StageTimer:
    """Accumulates named stage durations.

    >>> timer = StageTimer()          # or StageTimer(device="cuda:0")
    >>> with timer.stage("train"):
    ...     ...
    >>> timer.report()          # {'train': {'seconds': ..., 'calls': 1}}
    """

    def __init__(self, device=None):
        self._acc: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._order: List[str] = []
        self._sync = None
        if device is not None:
            import torch

            dev = torch.device(device)
            if dev.type == "cuda":
                self._sync = lambda: torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync is not None:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._calls[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._calls[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"seconds": self._acc[name], "calls": self._calls[name]}
            for name in self._order
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present) written to ``<log_dir>/trace.json``; a no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
