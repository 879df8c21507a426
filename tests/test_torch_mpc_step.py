"""The tracker's step kernels (``ops/mpc_step.py``) on the CPU: their plain
mirror held to the torch step, and the wrapper's contract.

The mirror is the kernels' arithmetic in torch (``csrc/mpc_step.cu``: the
same products and sums in the same order; the card holds the kernels to it
bit for bit, ``tests/test_torch_mpc_graph_card.py``).  It forms H and g
from J's structure, summing the track rows in index order, where
``_Problem.solve`` forms ``Jt @ J + λI`` and ``Jt @ r`` by matrix
products; both are float32.

Tolerances, with their reason: the two forms sum the same nonzero products
in other orders (each within γ_R ≈ R·2^-24 of the exact sum, R ≤ 142
rows), and J's θ entries are differences of prefix sums (kk_t − kk_{j+1})
that cancel, rounded apart by a few ulps of the prefix sums (the torch
step divides by L, the kernels multiply by its float32 reciprocal, as
torch does on the card).  So each entry of H is held within ``REL`` of
(|J|ᵀ|J| + λI) at that entry, g within ``REL`` of |J|ᵀ|r| and the cost
within ``REL`` of itself: ``REL`` = 2^-14, about 27 times the largest
reading on these cases (H 2.2e-6 at the sweep's (40, 30); g 8.1e-7; the
cost 1.3e-7).  The simulations
are held as ``tests/test_torch_mpc.py`` holds the port to JAX (states and
controls within 1e-3 over the whole run).
"""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.control import PathReference, mpc
from defensive_model_vae_tpu_torch.control.sweep import COMBOS
from defensive_model_vae_tpu_torch.ops import mpc_step as ms

REL = 2.0 ** -14
TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(windows, idxs, steps, cfg):
    """(states0, refs, last0) float32 tensors from fixture windows, as
    ``tests/test_torch_mpc_graph.py`` builds them."""
    s0, refs = [], []
    for i in idxs:
        wp = windows[i][:, [1, 2, 0]].astype(float)
        wp[0, 2] = 0.0
        v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
        init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
        refs.append(PathReference(wp, init).build(steps, cfg.prediction_horizon, cfg.dt))
        s0.append(mpc._initial_tracker_state(init))
    f32 = dict(dtype=torch.float32)
    return (torch.tensor(np.stack(s0), **f32), torch.tensor(np.stack(refs), **f32),
            torch.zeros((len(idxs), 2), **f32))


def _controls(B, M, seed, on_bounds=False):
    """An iterate u (B, M, 2) and last control (B, 2); ``on_bounds`` puts
    inputs exactly on ±7 and ±0.5 (the clip's derivative 1/2 there)."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn((B, M, 2), generator=gen) * torch.tensor([3.0, 0.3])
    last = torch.randn((B, 2), generator=gen) * torch.tensor([1.0, 0.1])
    if on_bounds:
        u[0, 0, 0], u[1, M - 1, 0], u[2, M // 2, 0] = 7.0, -7.0, 7.0
        u[0, 1, 1], u[1, 0, 1], u[2, M - 1, 1] = 0.5, -0.5, -0.5
        u[3, :, 0] = 9.0  # past the bound: derivative 0
    return u.contiguous(), last


CASES = {
    "first_solve": dict(P=30, M=20, first=True, on_bounds=False, freeze=False),
    "on_the_bounds": dict(P=30, M=20, first=False, on_bounds=True, freeze=False),
    "on_the_bounds_first": dict(P=30, M=20, first=True, on_bounds=True, freeze=False),
    "freeze_jacobian": dict(P=30, M=20, first=False, on_bounds=False, freeze=True),
    **{f"sweep_{P}x{M}": dict(P=P, M=M, first=False, on_bounds=False, freeze=False)
       for P, M in COMBOS},
    "full_hold_10x10": dict(P=10, M=10, first=True, on_bounds=True, freeze=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_form_mirror_holds_the_torch_systems(windows_sce1, case):
    c = CASES[case]
    cfg = mpc.MPCConfig(prediction_horizon=c["P"], control_horizon=c["M"], dt=0.02,
                        freeze_jacobian=c["freeze"])
    B, n = 4, 2 * c["M"]
    s0, refs, _ = _inputs(windows_sce1, (1, 3, 5, 7), 2, cfg)
    ref = refs[:, 1].contiguous()
    u, last = _controls(B, c["M"], seed=len(case), on_bounds=c["on_bounds"])
    prob = mpc._problem(cfg, torch.device("cpu"))
    du = prob.du_pair(torch.tensor(c["first"]))
    lam = torch.tensor([1e-3, 4e-3, 2.5e-4, 1e-2])
    it = 1  # λ read from lam (iteration 0 takes lm_lambda)
    r, J = prob.residuals(u, s0, ref, last, du, True)
    if c["freeze"]:  # J at the warm start [last, 0, …], r at the iterate
        u0 = torch.zeros_like(u)
        u0[:, 0] = last
        J = prob.residuals(u0, s0, ref, last, du, True)[1]
    Jt = J.transpose(1, 2)
    H_t = Jt @ J + lam[:, None, None] * prob.eye
    g_t = Jt @ r[:, :, None]
    H, g, cost = torch.empty((B, n, n)), torch.empty((B, n, 1)), torch.empty(B)
    first = torch.full((B,), int(c["first"]), dtype=torch.int32)
    ms.form(u, s0, ref, last, first, lam, H, g, cost, prob.consts, it, c["freeze"])
    scale_H = Jt.abs() @ J.abs() + lam[:, None, None] * prob.eye
    scale_g = Jt.abs() @ r.abs()[:, :, None]
    assert torch.isfinite(H).all() and torch.isfinite(g).all()
    assert bool(((H - H_t).abs() <= REL * scale_H).all())
    assert bool(((g - g_t).abs() <= REL * scale_g).all())
    assert bool(((cost - (r * r).sum(1)).abs() <= REL * (r * r).sum(1)).all())
    assert torch.equal(H, H.transpose(1, 2))


def test_form_takes_lm_lambda_at_the_first_iteration(windows_sce1):
    cfg = mpc.MPCConfig()
    prob = mpc._problem(cfg, torch.device("cpu"))
    s0, refs, _ = _inputs(windows_sce1, (1, 3), 2, cfg)
    u, last = _controls(2, cfg.control_horizon, seed=3)
    first = torch.zeros(2, dtype=torch.int32)
    out = {}
    for it, lam in ((0, torch.full((2,), 7.0)), (1, torch.full((2,), cfg.lm_lambda))):
        H, g, c = torch.empty((2, 40, 40)), torch.empty((2, 40, 1)), torch.empty(2)
        ms.form(u, s0, refs[:, 0].contiguous(), last, first, lam, H, g, c, prob.consts, it, False)
        out[it] = (H, g, c)
    assert all(torch.equal(a, b) for a, b in zip(out[0], out[1]))


@pytest.mark.parametrize("cfg", [
    mpc.MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02),
    mpc.MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05),
    mpc.MPCConfig(prediction_horizon=10, control_horizon=10, dt=0.05, freeze_jacobian=True),
], ids=["serve", "short", "frozen_full_hold"])
def test_kernel_step_mirror_tracks_as_the_torch_step(windows_sce1, cfg):
    """The kernels' step as its mirror runs it on the CPU (form, the LU's
    plain version, update; the last update applying the first control)
    against the torch step over a whole simulation."""
    s0, refs, last0 = _inputs(windows_sce1, (1, 3, 7), 48, cfg)
    last0 = last0 + torch.tensor([0.5, -0.05])
    s_k, c_k = mpc._simulate_kernels(cfg, s0, refs, last0)
    s_t, c_t = mpc._simulate_eager(cfg, s0, refs, last0)
    assert s_k.shape == s_t.shape == (3, 49, 4) and c_k.shape == c_t.shape == (3, 48, 2)
    assert torch.allclose(s_k, s_t, atol=TOL) and torch.allclose(c_k, c_t, atol=TOL)


def test_update_applies_the_first_control_and_the_next_warm_start(windows_sce1):
    """The last iteration's update: state Euler-stepped by u[:, 0] as
    ``_dynamics`` steps it, last = u[:, 0], the flags cleared, u ← [last,
    0, …]; an earlier iteration's leaves all four as they were."""
    cfg = mpc.MPCConfig()
    k = mpc._problem(cfg, torch.device("cpu")).consts
    s0, refs, _ = _inputs(windows_sce1, (1, 3), 2, cfg)
    ref = refs[:, 0].contiguous()
    u, last = _controls(2, cfg.control_horizon, seed=5)
    x = torch.zeros((2, 40, 1))  # a zero step: the trial is u clipped
    for apply in (False, True):
        bu = [u.clone(), s0.clone(), last.clone(), torch.ones(2, dtype=torch.int32),
              torch.full((2,), 1e-3)]
        ms.update(x, bu[0], bu[1], ref, bu[2], bu[3], bu[4], torch.full((2,), -1.0), k, 2, apply)
        if not apply:
            assert torch.equal(bu[0], u) and torch.equal(bu[1], s0)  # cost ≥ −1: rejected
            assert torch.equal(bu[2], last) and bu[3].tolist() == [1, 1]
            assert torch.allclose(bu[4], torch.full((2,), 4e-3))
            continue
        assert torch.equal(bu[2], u[:, 0]) and bu[3].tolist() == [0, 0]
        assert torch.equal(bu[0][:, 0], u[:, 0]) and not bu[0][:, 1:].any()
        want = s0 + mpc._dynamics(cfg, s0, u[:, 0]) * cfg.dt
        assert torch.allclose(bu[1], want, rtol=0, atol=1e-5)


def test_consts_are_the_problems_float32_numbers():
    cfg = mpc.MPCConfig(prediction_horizon=12, control_horizon=6, dt=0.025)
    prob = mpc._problem(cfg, torch.device("cpu"))
    k = prob.consts
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    assert torch.equal(prob.w_track[0], torch.tensor([k.w_th, k.w_v]))
    assert torch.equal(prob.w_track[-1], torch.tensor([k.wf_th, k.wf_v]))
    assert torch.equal(prob.sqrt_r, torch.tensor([k.sr_a, k.sr_d]))
    assert torch.equal(f32(k.dt), f32(cfg.dt)) and torch.equal(f32(k.lam0), f32(cfg.lm_lambda))
    assert k.inv_l == float(np.float32(1) / np.float32(cfg.wheelbase))
    assert (k.P, k.M) == (12, 6)


# ---- the wrapper's contract ---------------------------------------------------

def _form_args(P=30, M=20, B=3):
    cfg = mpc.MPCConfig(prediction_horizon=P, control_horizon=M)
    f = dict(dtype=torch.float32)
    args = dict(u=torch.zeros((B, M, 2), **f), state=torch.zeros((B, 4), **f),
                ref=torch.zeros((B, P + 1, 2), **f), last=torch.zeros((B, 2), **f),
                first=torch.zeros((B,), dtype=torch.int32), lam=torch.ones(B, **f),
                H=torch.zeros((B, 2 * M, 2 * M), **f), g=torch.zeros((B, 2 * M, 1), **f),
                cost0=torch.zeros(B, **f))
    return args, ms.Consts.of(cfg)


REFUSED = {"dtype": "u must be torch.float32", "first_dtype": "first must be torch.int32",
           "device": "one device", "shape": "ref must have shape", "contiguity": "contiguous",
           "past_bound_P": r"\(P, M\) = \(70, 20\)", "past_bound_M": r"\(P, M\) = \(40, 40\)"}


@pytest.mark.parametrize("bad", list(REFUSED))
def test_wrapper_refuses_what_the_kernels_do_not_take(bad):
    P, M = {"past_bound_P": (70, 20), "past_bound_M": (40, 40)}.get(bad, (30, 20))
    args, k = _form_args(P, M)
    if bad == "dtype":
        args["u"] = args["u"].double()
    elif bad == "first_dtype":
        args["first"] = args["first"].bool()
    elif bad == "device":
        args["H"] = args["H"].to("meta")
    elif bad == "shape":
        args["ref"] = args["ref"][:, :-1].contiguous()
    elif bad == "contiguity":
        args["H"] = args["H"].transpose(1, 2)
    with pytest.raises(ValueError, match=REFUSED[bad]):
        ms.form(**args, k=k, it=0, freeze=False)


def test_update_refuses_a_wrong_step_shape():
    args, k = _form_args()
    with pytest.raises(ValueError, match="x must have shape"):
        ms.update(torch.zeros((3, 40)), args["u"], args["state"], args["ref"], args["last"],
                  args["first"], args["lam"], args["cost0"], k, 0, False)


def test_kernel_path_refuses_shapes_past_the_bound_naming_them():
    for cfg, match in ((mpc.MPCConfig(prediction_horizon=80, control_horizon=20),
                        r"\(P, M\) = \(80, 20\)"),
                       (mpc.MPCConfig(lm_iters=0), "1 or more LM iterations")):
        with pytest.raises(ValueError, match=match):
            mpc._simulate_kernels(cfg, torch.zeros((2, 4)),
                                  torch.zeros((2, 4, cfg.prediction_horizon + 1, 2)),
                                  torch.zeros((2, 2)))
