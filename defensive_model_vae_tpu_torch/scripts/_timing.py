"""Timing shared by the measurement scripts: CUDA events on the card, the
host clock on the CPU (where the numbers are no device metric), entropy
seeds, and value-jittered copies of a SUT corpus for timed sweeps."""

from __future__ import annotations

import os
import re
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


def jittered_sut_copy(src_dir, dst_dir, eps=1e-3):
    """Copy the SUT corpus's CSVs with the surrounding vehicles' velocities
    (``sv<k>_vx``, ``sv<k>_vy``) shifted by +``eps`` m/s (JAX ``bench.py:764``).

    The episodes, their frame selection and the sweep's padded shapes stay
    the same (the vehicle count comes from which columns are present, and
    neither the stop conditions nor the path clusters read those
    velocities), while every input buffer differs: a warm sweep of one copy
    and a timed sweep of another with a fresh ``eps`` do the same work on
    inputs no earlier run has seen.  Written as ``data.csv_io.write_csv``
    writes (shortest ``repr``, NaN empty)."""
    from ..data.csv_io import read_csv, write_csv

    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        if not name.endswith(".csv"):
            continue
        frame = read_csv(os.path.join(src_dir, name))
        sv_vel = [c for c in frame.columns if re.fullmatch(r"sv\d+_v[xy]", c)]
        if sv_vel:
            frame = frame.assign(**{c: frame[c] + eps for c in sv_vel})
        write_csv(os.path.join(dst_dir, name), frame)
