"""The MPC tracker on the card: where a step's time goes, and the captured
step against the eager loop.

    python -m defensive_model_vae_tpu_torch.scripts.tracker_profile [--out f.json]

Inputs: ``control/tracker_inputs.py`` (the sce4 fixture's windows at the
serve configuration, rows repeated to the batch).  Prints one JSON line a
part:

- ``solve_capture``: ``torch.linalg.solve_ex`` on the LM's (2M, 2M)
  systems captured alone in a CUDA graph at each batch of ``SOLVE_ROWS``,
  replayed, and held bit for bit against the eager call;
- ``profile``: the eager step at 16 and 134 rows under ``torch.profiler``
  (``PROFILE_STEPS`` steps against fewer, so the set-up cancels): each
  device kernel's name, launches and µs a step, and the step's host wall
  (host clock, synchronised);
- ``captured``: ``_simulate`` (the captured step, replayed) bit for bit
  ``_simulate_eager`` at each batch of ``GRAPH_ROWS`` and each step count of
  ``GRAPH_STEPS``; the captures counted;
- ``walls``: at 16 rows and 512 steps, the eager loop and the captured
  step, each's wall (host clock), CUDA-event ms, device-busy ms (profiler,
  8 steps against 4, scaled to 512) and so its host share, and the
  capture's own seconds;
- ``serve``: the serve program of the committed sce4 checkpoint at batch
  16 and 512 steps, its tracker eager and captured, in turns.

Needs the card; nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from .. import scenarios
from .._device import resolve_device
from ..control import mpc
from ..control.tracker_inputs import CFG, inputs

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
# the batches that pick cuBLAS's batched LU run first
SOLVE_ROWS = (16, 38, 134, 1, 8, 2)
GRAPH_ROWS = (16, 38, 134, 2)
GRAPH_STEPS = (64, 512)
PROFILE_ROWS = (16, 134)
PROFILE_STEPS = (4, 12)
WALL_ROWS, WALL_STEPS = 16, 512
SERVE_SEED, SERVE_TURNS = 5, 2


def kernel_events(fn):
    """[(name, ns)] of the device kernels ``fn()`` ran (the profiler's raw
    trace; its event tree costs ~0.5 s a session)."""
    from torch import profiler

    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]


def per_step(fn_of_steps):
    """Each kernel's launches and µs a step: PROFILE_STEPS' difference."""
    lo, hi = PROFILE_STEPS
    runs = {}
    for steps in (lo, lo, hi):  # the first session's start-up discarded
        runs[steps] = kernel_events(lambda: fn_of_steps(steps))
    table = collections.defaultdict(lambda: [0.0, 0.0])
    for sign, steps in ((-1, lo), (1, hi)):
        for name, ns in runs[steps]:
            table[name][0] += sign / (hi - lo)
            table[name][1] += sign * ns / 1e3 / (hi - lo)
    busy_us = sum(v[1] for v in table.values())
    rows = sorted(((n, round(c, 2), round(us, 3)) for n, (c, us) in table.items()
                   if abs(c) > 1e-9 or abs(us) > 1e-6), key=lambda r: -r[2])
    return busy_us, rows


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def event_ms(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def solve_capture(dev):
    """solve_ex captured alone at each batch: bit for bit eager, or the
    capture's error."""
    out = {}
    n = 2 * CFG.control_horizon
    gen = torch.Generator().manual_seed(0)
    for B in SOLVE_ROWS:
        J = torch.randn((B, 2 * n, n), generator=gen).to(dev)
        H = J.transpose(1, 2) @ J + 1e-3 * torch.eye(n, device=dev)
        g = torch.randn((B, n, 1), generator=gen).to(dev)
        eager = torch.linalg.solve_ex(H, g)[0]
        names = sorted({n for n, _ in kernel_events(lambda: torch.linalg.solve_ex(H, g))})
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(s):
                torch.linalg.solve_ex(H, g)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    x = torch.linalg.solve_ex(H, g)[0]
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(s)
            graph.replay()
            torch.cuda.synchronize()
            out[B] = {"captured": True, "bit_for_bit": bool(torch.equal(x, eager)),
                      "kernels": names}
        except Exception as e:  # a refused capture is the finding here
            torch.cuda.synchronize()
            out[B] = {"captured": False, "error": f"{type(e).__name__}: {e}"[:300],
                      "kernels": names}
        print(json.dumps({"solve_capture_rows": B, **out[B]}), flush=True)
    return out


def profile(dev):
    """The eager step's kernels at each batch of ``PROFILE_ROWS``."""
    prof = {}
    for B in PROFILE_ROWS:
        s0, refs, l0 = inputs(B, PROFILE_STEPS[1], dev)
        busy, rows = per_step(lambda S: mpc._simulate_eager(CFG, s0, refs[:, :S], l0))
        host, _ = wall_s(lambda: mpc._simulate_eager(CFG, s0, refs, l0))
        prof[B] = {"device_busy_us_per_step": busy, "kernels_per_step": sum(r[1] for r in rows),
                   "eager_wall_ms_per_step": 1e3 * host / PROFILE_STEPS[1],
                   "top": rows[:25]}
    return prof


def captured(dev):
    """The captured step against the eager loop at each shape."""
    cap = {}
    for B in GRAPH_ROWS:
        for S in GRAPH_STEPS:
            s0, refs, l0 = inputs(B, S, dev)
            before = mpc.graph_captures
            a = mpc._simulate(CFG, s0, refs, l0)
            again = mpc.graph_captures
            b = mpc._simulate(CFG, s0, refs, l0)
            e = mpc._simulate_eager(CFG, s0, refs, l0)
            cap[f"{B}x{S}"] = {
                "bit_for_bit": all(torch.equal(x, y) for x, y in zip(a, e)),
                "replay_repeats": all(torch.equal(x, y) for x, y in zip(a, b)),
                "captures_first_call": again - before,
                "captures_second_call": mpc.graph_captures - again,
                "finite": bool(torch.isfinite(a[0]).all())}
    return cap


def walls(dev):
    """The eager loop and the captured step at WALL_ROWS x WALL_STEPS."""
    B, S = WALL_ROWS, WALL_STEPS
    s0, refs, l0 = inputs(B, S, dev)
    mpc._graphs.clear()
    forms = {"eager": lambda n: mpc._simulate_eager(CFG, s0, refs[:, :n], l0),
             "step_graph": lambda n: mpc._simulate(CFG, s0, refs[:, :n], l0)}
    out = {}
    t_first, _ = wall_s(lambda: forms["step_graph"](64))
    t_again, _ = wall_s(lambda: forms["step_graph"](64))
    out["step_graph_capture_s"] = t_first - t_again
    for name, fn in forms.items():
        w = [wall_s(lambda: fn(S))[0] for _ in range(2)]
        ms = event_ms(lambda: fn(S))
        lo, hi = 4, 8
        d = [sum(ns for _, ns in kernel_events(lambda: fn(n))) / 1e6 for n in (lo, lo, hi)]
        busy = d[2] + (d[2] - d[1]) / (hi - lo) * (S - hi)
        out[name] = {"wall_s": w, "cuda_event_ms": ms, "device_busy_ms": busy,
                     "host_share": 1 - busy / ms}
    return out


def serve(dev):
    """The serve program of the committed sce4 checkpoint, its tracker eager
    and captured, in turns."""
    from ..control import device_reference as dr
    from ..pipeline import fixture_starts
    from ..train import load_checkpoint

    params, cfg, manifest = load_checkpoint(os.path.join(REPO, "results", "checkpoints",
                                                         "sce4"), dev)
    w = np.load(scenarios.get("sce4").fixture_windows)[:WALL_ROWS]
    starts, inits = fixture_starts(w)
    inits = inits.astype(np.float32)
    # make_serve_fn binds mpc._simulate when it is made
    real, fns = mpc._simulate, {}
    for name, sim in (("eager", mpc._simulate_eager), ("captured", real)):
        mpc._simulate = sim
        try:
            fns[name] = dr.make_serve_fn(params, cfg, CFG, WALL_STEPS,
                                         manifest.get("offset_mode", True))
        finally:
            mpc._simulate = real

    def run(name):
        return fns[name](SERVE_SEED, starts, inits)

    run("captured")  # the warm-up: the batch's graph captured
    out = {n: {"wall_s": [], "cuda_event_ms": []} for n in fns}
    outs = {}
    for _ in range(SERVE_TURNS):
        for name in ("eager", "captured", "captured", "eager"):
            t, outs[name] = wall_s(lambda: run(name))
            out[name]["wall_s"].append(t)
            out[name]["cuda_event_ms"].append(event_ms(lambda: run(name)))
    out["bit_for_bit"] = all(torch.equal(x, y) for x, y in
                             zip(outs["eager"], outs["captured"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines' objects to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tracker_profile needs a CUDA card")
    dev = resolve_device("cuda")
    result = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    for part in (solve_capture, profile, captured, walls, serve):
        result[part.__name__] = obj = part(dev)
        print(json.dumps({part.__name__: obj}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
