"""The program's spans on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_card.py -q

The spans' host times and ``torch.profiler``'s device events must lie on
one clock, so that an idle stretch of the card is named by the span the
host was in: a 20 ms host sleep inside a span between two kernels is the
card's longest idle stretch in the profile, its edges within 0.2 ms of the
span's.  A warm serve request replays its tracker step once a step and
runs the LU kernel ``lm_iters`` times a step, by the kernel's own count,
and its replay loop's span carries the loop's device time.
"""

import pathlib
import time

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.control import MPCConfig, mpc
from defensive_model_vae_tpu_torch.ops.lu_solve import launches
from defensive_model_vae_tpu_torch.serving import build_serve_fn
from defensive_model_vae_tpu_torch.utils.profiling import recording, span

ROOT = pathlib.Path(__file__).resolve().parent.parent
# about 5 ms of spinning on an H100's clock
SPIN_CYCLES = 10_000_000


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_the_profiler_and_the_spans_share_a_clock():
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda()
    torch.cuda._sleep(SPIN_CYCLES)  # the kernel's first launch outside the profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]):  # a process's first profile starts slowly
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as rec:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(dev)
        with span("test.host_sleep"):
            time.sleep(0.02)
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(dev)
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0)
    (sleep,) = rec.spans
    assert len(kernels) >= 2, kernels
    gaps = [(a[1], b[0]) for a, b in zip(kernels, kernels[1:])]
    gap = max(gaps, key=lambda g: g[1] - g[0])
    edges_ms = [(gap[0] - sleep.start_ns) / 1e6, (gap[1] - sleep.end_ns) / 1e6]
    print(f"kernels (ms from the span's start) "
          f"{[[(t - sleep.start_ns) / 1e6 for t in k] for k in kernels]}, span "
          f"{(sleep.end_ns - sleep.start_ns) / 1e6:.4f} ms, edge offsets (gap - span) "
          f"{edges_ms} ms")
    assert all(abs(e) < 0.2 for e in edges_ms), edges_ms


@pytest.mark.gpu
def test_a_warm_request_replays_and_counts_its_lu_solves():
    dev = _cuda()
    steps, batch = 512, 16
    serve = build_serve_fn(str(ROOT / "results/checkpoints/sce1"), steps, 0.02, device=dev)
    starts = np.zeros((batch, 2), np.float32)
    inits = np.tile(np.array([[0.0, 0.0, 1.57, 0.0, 10.0]], np.float32), (batch, 1))
    serve(1, starts, inits)  # captures the step at this batch
    torch.cuda.synchronize(dev)
    before = launches(dev), mpc.graph_steps, mpc.graph_captures
    requests = 3
    with recording() as rec:
        for seed in range(2, 2 + requests):
            serve(seed, starts, inits)
        torch.cuda.synchronize(dev)
    after = launches(dev), mpc.graph_steps, mpc.graph_captures
    lu, replayed, captured = (a - b for a, b in zip(after, before))
    assert lu == requests * steps * MPCConfig().lm_iters
    assert replayed == requests * steps and captured == 0
    assert [r.name for r in rec.spans] == ["mpc.replays"] * requests
    for replays in rec.spans:
        host_ms = (replays.end_ns - replays.start_ns) / 1e6
        print(f"mpc.replays: device {replays.device_ms:.3f} ms, host {host_ms:.3f} ms, "
              f"{1e3 * replays.device_ms / steps:.2f} us a step")
        assert replays.device_ms > 0
