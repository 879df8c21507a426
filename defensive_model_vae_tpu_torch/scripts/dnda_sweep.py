"""Synthetic SUT frames for the DNDA collision sweep, and the sweep's times.

    python -m defensive_model_vae_tpu_torch.scripts.dnda_sweep \\
        [--frames 256] [--tile 3072] [--reps 3] [--device cuda] [--profile]

The frames are what the episode driver (``dnda.calculator``) prepares from a
CSV row: an ego state drawn along one of the four scenarios' straight
baselines (world coordinates, heading within a few degrees of the road,
2–15 m/s, lateral offset within ±1.5 m) and 0–6 surrounding vehicles
5–45 m ahead on the road (moving either way, stopped, or braking to a
reversal inside the 3 s horizon; the registry's bike dimensions for
``bike_svs``), rotated, related to the baseline and prepared by
``dnda.core.prepare_frame`` exactly as the driver does (horizon 3 s, step
0.1 s, 400 baseline points).

The script prints one JSON line: the frames' shapes, the card sweep of the
frames tiled to ``--tile`` frames in each SAT dtype (its wall time on the
host clock, padding and result included; its CUDA-event time over the
chunks' copies and compute; the host padding alone; the peak device memory
over it), and the numpy oracle's time over the frames scaled to the tile.
``--profile`` adds one 256-frame chunk under ``torch.profiler``: its device
kernels, their count and their busy time.  On the CPU (``--device cpu``)
every time is the host's and no device metric.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import time
from typing import Iterator, List

import numpy as np

from .. import scenarios
from ..dnda import calculator, core, device_sweep
from ..dnda.geometry import Road, Vehicle

HORIZON, STEP, BASEPOINTS = 3.0, 0.1, 400
DTYPES = ("float32", "float64")


def _vehicle(rng, pos, d, nrm, ahead, lateral):
    """One surrounding vehicle's world row: position, velocity, acceleration
    and yaw (degrees); moving along the road either way, stopped, or braking
    to a reversal inside the horizon."""
    p = pos + d * ahead + nrm * lateral
    kind = rng.integers(4)
    if kind == 0:  # moving along the road, either way
        v = d * rng.uniform(-12.0, 12.0)
        a = d * rng.uniform(-1.0, 1.0)
    elif kind == 1:  # stopped (a pure lateral acceleration now and then)
        v = np.zeros(2)
        a = nrm * rng.choice([0.0, rng.uniform(-1.5, 1.5)])
    elif kind == 2:  # braking: its velocity reverses inside the horizon
        s = rng.uniform(1.0, 6.0)
        v, a = d * s, -d * s / rng.uniform(0.5, 2.5)
    else:  # crossing the road
        v = nrm * rng.uniform(-6.0, 6.0)
        a = np.zeros(2)
    yaw = math.degrees(math.atan2(v[1], v[0])) if v.any() else rng.uniform(-180.0, 180.0)
    return p, v, a, yaw


def synthetic_inputs(seed: int = 0) -> Iterator[tuple]:
    """Endless candidate frames from ``seed``, the scenarios in turn:
    ``(road kwargs, ego Vehicle kwargs, rotated baseline, (V, 9) vehicle
    rows)``, made from a world-frame CSV row by the driver's own steps
    (``calculator._iter_frame_preps``)."""
    rng = np.random.default_rng(seed)
    keys = list(scenarios.keys())
    for i in itertools.count():
        sce = scenarios.get(keys[i % len(keys)])
        base = calculator.baseline_for(sce)
        rot, angle = calculator._rotate_to_x(base)
        j = int(rng.integers(0, len(base) - BASEPOINTS - 50))
        d = base[j + 1] - base[j]
        d = d / np.linalg.norm(d)
        nrm = np.array([-d[1], d[0]])
        pos = base[j] + nrm * rng.uniform(-1.5, 1.5)
        yaw = math.atan2(d[1], d[0]) + rng.normal(0.0, 0.05)
        speed = rng.uniform(2.0, 15.0)
        acc = rng.uniform(-2.0, 2.0)
        row = {"ego_x": pos[0], "ego_y": pos[1],
               "ego_vx": speed * math.cos(yaw), "ego_vy": speed * math.sin(yaw),
               "ego_ax": acc * math.cos(yaw), "ego_ay": acc * math.sin(yaw),
               "ego_yaw": math.degrees(yaw)}
        n_sv = int(rng.integers(0, 7))
        for k in range(1, n_sv + 1):
            p, v, a, sv_yaw = _vehicle(rng, pos, d, nrm, rng.uniform(5.0, 45.0),
                                       rng.uniform(-4.0, 4.0))
            row.update({f"sv{k}_x": p[0], f"sv{k}_y": p[1], f"sv{k}_vx": v[0],
                        f"sv{k}_vy": v[1], f"sv{k}_ax": a[0], f"sv{k}_ay": a[1],
                        f"sv{k}_yaw": sv_yaw})
        r = calculator._rotate_row(row, angle, n_sv)
        rel, init_q = calculator._relative_theta_init_q(r["ego_x"], r["ego_y"],
                                                         r["ego_yaw"], rot)
        cfg = sce.dnda
        road = dict(cross_centerline=False, lane_num=cfg.lane_num,
                    lane_egodirect=cfg.lane_egodirect, lane_width=cfg.lane_width,
                    max_absolute_acc=cfg.max_absolute_acc)
        ego = dict(x=r["ego_x"], y=r["ego_y"], length=7.2, width=2.3,
                   speed_x=r["ego_vx"], speed_y=r["ego_vy"],
                   speed=math.hypot(r["ego_vx"], r["ego_vy"]), absolute_theta=r["ego_yaw"],
                   acc=math.cos(r["ego_yaw"]) * r["ego_ax"]
                   + math.sin(r["ego_yaw"]) * r["ego_ay"],
                   init_q=init_q, lane_posi=1, relative_theta=math.radians(rel))
        yield road, ego, rot, calculator._sur_input(r, n_sv, sce)


def synthetic_frames(n: int, seed: int = 0) -> List[core.FramePrep]:
    """The first ``n`` candidates of :func:`synthetic_inputs` that
    ``prepare_frame`` accepts (the driver skips the others too), prepared."""
    out: List[core.FramePrep] = []
    for road, ego, rot, sur in synthetic_inputs(seed):
        if len(out) == n:
            break
        try:
            out.append(core.prepare_frame(HORIZON, STEP, Road(**road), Vehicle(**ego), rot,
                                          sur, BASEPOINTS))
        except (ValueError, ZeroDivisionError):
            continue
    return out


def _args(preps):
    return ([p.ego_rects for p in preps], [p.unit_arc_paths for p in preps],
            [p.ego_speed for p in preps], [p.sur_array for p in preps], HORIZON, STEP)


def time_sweep(preps, dev, sat_dtype: str, reps: int = 3) -> dict:
    """The sweep of ``preps`` on ``dev`` (a warm call first, then ``reps``
    timed calls, medians): ``wall_s`` (host clock around ``sweep_frames``),
    ``pad_s`` (host padding into pinned memory alone), ``sweep_ms`` (CUDA
    events around the chunks' copies, compute and the indices' return; the
    host clock on the CPU), ``peak_mem_mb`` (device memory over the sweep)."""
    import torch

    from ._timing import timed

    cuda = dev.type == "cuda"
    core.sweep_frames(preps, device=dev, sat_dtype=sat_dtype)
    walls, pads, sweeps = [], [], []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ci = core.sweep_frames(preps, device=dev, sat_dtype=sat_dtype)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        padded = device_sweep.pad_frames(*_args(preps), sat_dtype, pin=cuda)
        pads.append(time.perf_counter() - t0)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        s, again = timed(lambda: device_sweep.sweep_padded(padded, dev), dev)
        sweeps.append(1e3 * s)
        if any(not np.array_equal(a, b) for a, b in zip(ci, again)):
            raise AssertionError("two sweeps of the same frames differ")
    return {"frames": len(preps), "wall_s": float(np.median(walls)),
            "pad_s": float(np.median(pads)), "sweep_ms": float(np.median(sweeps)),
            "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2**20 if cuda else None,
            "chunks": math.ceil(len(preps) / device_sweep._CHUNK)}


def profile_chunk(preps, dev, sat_dtype: str = "float32") -> dict:
    """One 256-frame chunk under ``torch.profiler``: its device kernels'
    count and busy milliseconds, and the five kernels of most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    padded = device_sweep.pad_frames(*_args(preps[: device_sweep._CHUNK]), sat_dtype,
                                     pin=True)
    device_sweep.sweep_padded(padded, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        device_sweep.sweep_padded(padded, dev)
        torch.cuda.synchronize(dev)
    by_name: dict = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            n += 1
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_events": n, "busy_ms": sum(by_name.values()) / 1e6,
            "top_ms": {k[:80]: v / 1e6 for k, v in top}}


def shapes(preps) -> dict:
    return {"frames": len(preps),
            "paths": [min(len(p.usable) for p in preps), max(len(p.usable) for p in preps)],
            "points": max(r.shape[0] for p in preps for r in p.ego_rects),
            "vehicles": [min(len(p.sur_array) for p in preps),
                         max(len(p.sur_array) for p in preps)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=256, help="distinct frames drawn")
    ap.add_argument("--tile", type=int, default=3072, help="frames swept (the drawn, tiled)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    from .._device import resolve_device
    from ._timing import device_name

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    preps = synthetic_frames(args.frames)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = core.sweep_frames(preps, host=True)
    host_s = time.perf_counter() - t0
    tiled = (preps * math.ceil(args.tile / len(preps)))[: args.tile]
    out = {"device": device_name(dev), **shapes(preps), "prepare_s": prep_s,
           "host_sweep_s": host_s, "host_sweep_s_scaled": host_s * len(tiled) / len(preps)}
    for dt in DTYPES:
        card = core.sweep_frames(preps, device=dev, sat_dtype=dt)
        if any(not np.array_equal(a, b) for a, b in zip(card, host)):
            raise SystemExit(f"the {dt} sweep on {dev} differs from the numpy oracle")
        out[dt] = time_sweep(tiled, dev, dt, args.reps)
    if args.profile and dev.type == "cuda":
        out["profile"] = profile_chunk(tiled, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
