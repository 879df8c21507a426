"""Timing shared by the measurement scripts: CUDA events on the card, the
host clock on the CPU (where the numbers are no device metric)."""

from __future__ import annotations

import time

import torch


def timed(fn, dev):
    """(seconds, result) of ``fn()``: CUDA events around it and a
    synchronise on the card; the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def fresh_seed(lo=1 << 20) -> int:
    """An entropy seed for a timed run, so no two reps see the same inputs."""
    import secrets

    return lo + secrets.randbelow((1 << 30) - lo)


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
