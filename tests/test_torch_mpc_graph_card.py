"""The tracker's captured step graph and its LU kernel on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_mpc_graph_card.py -q

The captured step replays the eager step's kernels on the same shapes, so
captured and eager states and controls are held bit for bit (no
tolerance).  The LU kernel against ``torch.linalg.solve_ex`` as
``chip_smoke.py`` holds it: each solve's normwise backward error within
n·2^-24.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.control import mpc
from defensive_model_vae_tpu_torch.control import tracker_inputs as tp
from defensive_model_vae_tpu_torch.ops import lu_solve as lus


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [64, 512])
@pytest.mark.parametrize("rows", [2, 16, 38, 134])
def test_captured_equals_eager_bit_for_bit(rows, steps):
    dev = _cuda()
    s0, refs, l0 = tp.inputs(rows, steps, dev)
    got = mpc._simulate(tp.CFG, s0, refs, l0)
    assert torch.isfinite(got[0]).all()
    assert _equal(got, mpc._simulate_eager(tp.CFG, s0, refs, l0))


@pytest.mark.gpu
def test_the_kernel_counts_its_runs_in_replays():
    """The LU kernel counts its own runs on the card: a captured call at a
    cached batch runs it lm_iters times a replayed step, and no more."""
    dev = _cuda()
    s0, refs, l0 = tp.inputs(16, 64, dev)
    mpc._simulate(tp.CFG, s0, refs, l0)  # captured (or already cached)
    lus.reset_launches(dev)
    mpc._simulate(tp.CFG, s0, refs, l0)
    assert lus.launches(dev) == 64 * tp.CFG.lm_iters


@pytest.mark.gpu
def test_a_second_call_replays_without_capturing():
    dev = _cuda()
    s0, refs, l0 = tp.inputs(16, 64, dev)
    first = mpc._simulate(tp.CFG, s0, refs, l0)
    before = mpc.graph_captures
    again = mpc._simulate(tp.CFG, s0[:, :], refs[:, :32], l0)  # another step count
    assert mpc.graph_captures == before
    assert _equal((again[0], again[1]), (first[0][:, :33], first[1][:, :32]))


@pytest.mark.gpu
def test_a_new_batch_evicts_within_the_bound(monkeypatch):
    dev = _cuda()
    monkeypatch.setattr(mpc, "GRAPH_CACHE_MAX", 2)
    monkeypatch.setattr(mpc, "_graphs", type(mpc._graphs)())
    for rows in (3, 5, 7):
        s0, refs, l0 = tp.inputs(rows, 64, dev)
        mpc._simulate(tp.CFG, s0, refs, l0)
    assert [k[1] for k in mpc._graphs] == [5, 7]
    before = mpc.graph_captures
    s0, refs, l0 = tp.inputs(3, 64, dev)
    mpc._simulate(tp.CFG, s0, refs, l0)
    assert mpc.graph_captures == before + 1 and [k[1] for k in mpc._graphs] == [7, 3]


@pytest.mark.gpu
def test_a_failed_capture_raises_and_returns_nothing(monkeypatch):
    dev = _cuda()
    real = mpc._step
    calls = []

    def syncing_step(prob, buf):
        # a host synchronisation: allowed eagerly, refused while capturing
        calls.append(1)
        real(prob, buf)
        torch.cuda.synchronize()

    monkeypatch.setattr(mpc, "_step", syncing_step)
    monkeypatch.setattr(mpc, "_graphs", type(mpc._graphs)())
    s0, refs, l0 = tp.inputs(11, 64, dev)
    with pytest.raises(RuntimeError, match="capturing the tracker step at batch 11"):
        mpc._simulate(tp.CFG, s0, refs, l0)
    assert len(calls) == 2 and not mpc._graphs  # the warm step, then the capture


@pytest.mark.gpu
def test_replay_from_a_server_thread_after_the_warm_up():
    """The warm-up (4 steps at the batch) captures the graph; a request,
    served from the server's own thread at the full step count, replays it
    and returns the program's own answer."""
    from defensive_model_vae_tpu_torch import serving

    dev = _cuda()
    ckpt = scenarios.REPO_ROOT / "results" / "checkpoints" / "sce4"
    server = serving.serve_checkpoint(str(ckpt), 4, 64, dt=0.02,
                                      port=0, warm_seed=1, device=dev)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        before = mpc.graph_captures
        rows = [{"start_x": -193.3 + i, "start_y": 50.0} for i in range(3)]
        body = json.dumps({"requests": rows, "seed": 7}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/serve",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answer = json.loads(r.read())
        assert mpc.graph_captures == before
        starts, inits, k = serving._parse_requests(rows, 4)
        states, _ = server.serve_fns["default"](7, starts, inits)
        got = [None if s is None else np.asarray(s, np.float32) for s in answer["states"]]
        for b in range(k):
            if got[b] is not None:
                assert np.array_equal(got[b], states[b].cpu().numpy())
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 134])
def test_lu_kernel_holds_the_backward_error_of_its_plain_version(rows):
    dev = _cuda()
    lus.reset_launches(dev)
    n = 2 * tp.CFG.control_horizon
    gen = torch.Generator().manual_seed(rows)
    J = torch.randn((rows, 2 * n, n), generator=gen).to(dev)
    H = (J.transpose(1, 2) @ J + 1e-3 * torch.eye(n, device=dev)).contiguous()
    g = torch.randn((rows, n, 1), generator=gen).to(dev)
    Hd, gd = H.double(), g.double()
    for x in (lus.lu_solve(H, g), lus._lu_solve_plain(H, g)):
        r = (Hd @ x.double() - gd).abs().amax(dim=(1, 2))
        norm = (Hd.abs().sum(dim=2).amax(dim=1) * x.double().abs().amax(dim=(1, 2))
                + gd.abs().amax(dim=(1, 2)))
        assert float((r / norm).max()) <= n * 2.0 ** -24
    assert lus.launches(dev) == 1
    with pytest.raises(ValueError, match="contiguous"):
        lus.lu_solve(H.transpose(1, 2), g)
