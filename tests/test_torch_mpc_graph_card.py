"""The tracker's captured step graph, its step kernels and its LU kernel
on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_mpc_graph_card.py -q

The captured step replays the kernel step's launches (``_kernel_step``: 3
× form, LU, update) on the same shapes, so captured and uncaptured states
and controls are held bit for bit (no tolerance); so are the step kernels
and their plain mirror (``ops/mpc_step.py``: the same operations in the
same order).  The kernels' simulation against the torch step
(``_simulate_eager``, TF32 off), which sums in other orders, within
``KERNEL_STATE_TOL`` (the JAX parity tolerance of
``tests/test_torch_mpc.py``, 65 times the largest reading at 16–134 rows ×
512 steps, 1.5e-5) and, for the controls, each row's mean gap over the
run within ``KERNEL_CONTROL_MEAN_TOL`` (14 times the reading, 7.0e-6)
and any single control within ``KERNEL_CONTROL_TOL`` (43 times, 2.3e-4):
near a bound or a tie one control can part for a step, which the mean
holds (as the serve cell's ``control_mean_gap`` does).  The LU kernel against ``torch.linalg.solve_ex`` as
``chip_smoke.py`` holds it: each solve's normwise backward error within
n·2^-24; its register form bit for bit its shared-memory form at every
order the repo runs, and each form's count of its runs on the card.
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
from defensive_model_vae_tpu_torch.control.sweep import COMBOS
from defensive_model_vae_tpu_torch.ops import lu_solve as lus
from defensive_model_vae_tpu_torch.ops import mpc_step as ms
from defensive_model_vae_tpu_torch.scripts import lu_checks as luc

KERNEL_STATE_TOL, KERNEL_CONTROL_MEAN_TOL, KERNEL_CONTROL_TOL = 1e-3, 1e-4, 1e-2


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
    """The captured graph against the same kernels launched without a
    capture."""
    dev = _cuda()
    s0, refs, l0 = tp.inputs(rows, steps, dev)
    got = mpc._simulate(tp.CFG, s0, refs, l0)
    assert torch.isfinite(got[0]).all()
    assert _equal(got, mpc._simulate_kernels(tp.CFG, s0, refs, l0))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16, 38, 134])
def test_kernel_step_tracks_the_torch_step(rows):
    dev = _cuda()
    s0, refs, l0 = tp.inputs(rows, 512, dev)
    got = mpc._simulate(tp.CFG, s0, refs, l0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = mpc._simulate_eager(tp.CFG, s0, refs, l0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gap_c = (got[1] - want[1]).abs()
    assert float((got[0] - want[0]).abs().max()) <= KERNEL_STATE_TOL
    assert float(gap_c.mean(dim=1).max()) <= KERNEL_CONTROL_MEAN_TOL
    assert float(gap_c.max()) <= KERNEL_CONTROL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16, 134])
@pytest.mark.parametrize("it,first,freeze", [(0, 1, False), (1, 0, False), (2, 1, True)])
def test_step_kernels_equal_their_mirror_bit_for_bit(rows, it, first, freeze):
    """One LM iteration's form and update against ``_form_plain`` and
    ``_update_plain`` on the card, on controls that sit on their bounds."""
    dev = _cuda()
    cfg = tp.CFG
    k, M = mpc._problem(cfg, dev).consts, cfg.control_horizon
    s0, refs, _ = tp.inputs(rows, 2, dev)
    ref = refs[:, 1].contiguous()
    gen = torch.Generator().manual_seed(rows + it)
    u = (torch.randn((rows, M, 2), generator=gen) * torch.tensor([3.0, 0.3])).to(dev)
    u[0, 2, 0], u[1, M - 1, 0], u[2, 3, 1], u[3, 0, 1] = 7.0, -7.0, -0.5, 0.5
    last = (torch.randn((rows, 2), generator=gen) * 0.3).to(dev)
    lam = (torch.rand(rows, generator=gen) * 1e-2).to(dev)
    flags = torch.full((rows,), first, dtype=torch.int32, device=dev)
    outs = {}
    for name, form, update in (("kernel", ms.form, ms.update),
                               ("mirror", ms._form_plain, ms._update_plain)):
        H, g = torch.empty((rows, 2 * M, 2 * M), device=dev), torch.empty((rows, 2 * M, 1),
                                                                          device=dev)
        cost = torch.empty(rows, device=dev)
        form(u, s0, ref, last, flags, lam, H, g, cost, k, it, freeze)
        x = lus.lu_solve(H, g)
        st = [u.clone(), s0.clone(), last.clone(), flags.clone(), lam.clone()]
        update(x, st[0], st[1], ref, st[2], st[3], st[4], cost, k, it, it == 2)
        outs[name] = [H, g, cost, *st]
    assert all(torch.equal(a, b) for a, b in zip(outs["kernel"], outs["mirror"]))


@pytest.mark.gpu
def test_the_step_kernels_count_their_runs_in_replays():
    """A step is 3 x (form, LU, update): 9 launches, each kernel counting
    lm_iters runs a replayed step."""
    dev = _cuda()
    s0, refs, l0 = tp.inputs(16, 64, dev)
    mpc._simulate(tp.CFG, s0, refs, l0)  # captured (or already cached)
    ms.reset_launches(dev)
    lus.reset_launches(dev)
    mpc._simulate(tp.CFG, s0, refs, l0)
    per = 64 * tp.CFG.lm_iters
    assert (ms.launches(dev, "form"), ms.launches(dev, "update"), lus.launches(dev)) == \
        (per, per, per)
    assert ms.launches(dev) + lus.launches(dev) == 9 * 64


@pytest.mark.gpu
def test_a_shape_past_the_kernels_bound_raises_naming_it():
    dev = _cuda()
    cfg = mpc.MPCConfig(prediction_horizon=80, control_horizon=20)
    s0, refs, l0 = tp.inputs(2, 4, dev, cfg)
    with pytest.raises(ValueError, match=r"\(P, M\) = \(80, 20\)"):
        mpc._simulate(cfg, s0, refs, l0)


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
    real = mpc._kernel_step
    calls = []

    def syncing_step(prob, buf):
        # a host synchronisation: allowed eagerly, refused while capturing
        calls.append(1)
        real(prob, buf)
        torch.cuda.synchronize()

    monkeypatch.setattr(mpc, "_kernel_step", syncing_step)
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


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 134])
@pytest.mark.parametrize("P,M", COMBOS)
def test_lu_register_form_equals_shared_memory_form(P, M, rows):
    dev = _cuda()
    cfg = mpc.MPCConfig(prediction_horizon=P, control_horizon=M, dt=tp.CFG.dt)
    H, g = luc.lm_systems(rows, dev, cfg)
    assert lus.instance(2 * M)[0] == "reg"
    reg, smem = lus.lu_solve(H, g, form="reg"), lus.lu_solve(H, g, form="smem")
    assert torch.isfinite(reg).all()
    assert torch.equal(reg, smem) and torch.equal(lus.lu_solve(H, g), reg)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["reg", "smem"])
def test_each_form_counts_its_runs_in_a_graph_replay(form):
    """One eager call counts one run of its form; a captured call counts
    one at each replay; the other form's count stays 0."""
    dev = _cuda()
    H, g = luc.lm_systems(16, dev)
    other = next(f for f in lus.FORMS if f != form)
    lus.reset_launches(dev)
    lus.lu_solve(H, g, form=form)
    assert (lus.launches(dev, form), lus.launches(dev, other)) == (1, 0)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            x = lus.lu_solve(H, g, form=form)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(s)
    assert lus.launches(dev, form) == 1  # a capture runs nothing
    for _ in range(3):
        graph.replay()
    assert (lus.launches(dev, form), lus.launches(dev, other)) == (4, 0)
    assert lus.launches(dev) == 4
    assert torch.equal(x, lus.lu_solve(H, g, form=form))
