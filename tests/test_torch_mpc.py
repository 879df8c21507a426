"""The port's batched MPC tracker against the JAX package, on the CPU.

Both sides run float32.  Tolerances: rollouts atol 1e-4 (prefix sums
against a sequential scan, 100 steps); the residual Jacobian atol 1e-4 of
its scale (forward sensitivities against ``jax.jacfwd``); tracked states
atol 1e-3 against JAX ``track_batch`` over the whole simulation (the LM
solve is contractive, so summation-order differences do not grow).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from conftest import FIXTURES
from defensive_model_vae_tpu.control import MPCConfig as JMPCConfig
from defensive_model_vae_tpu.control import track_batch as j_track_batch
from defensive_model_vae_tpu.control.mpc import _residuals as j_residuals
from defensive_model_vae_tpu.control.mpc import rollout as j_rollout

from defensive_model_vae_tpu_torch.control import (
    MPCConfig, PathReference, rollout, track, track_batch)
from defensive_model_vae_tpu_torch.control.mpc import (
    _initial_tracker_state, _Problem)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window_paths(windows, idxs):
    wps, inits = [], []
    for i in idxs:
        wp = windows[i][:, [1, 2, 0]].astype(float)
        wp[0, 2] = 0.0
        v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
        wps.append(wp)
        inits.append([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
    return np.stack(wps), np.asarray(inits)


def test_rollout_matches_jax():
    cfg = MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.01)
    rng = np.random.default_rng(0)
    state0 = np.array([1.0, -2.0, 0.3, 4.0], np.float32)
    # includes inputs beyond the bounds (clipped by the dynamics)
    controls = (rng.standard_normal((100, 2)) * [5.0, 0.4]).astype(np.float32)
    ref = np.asarray(j_rollout(JMPCConfig(prediction_horizon=10, control_horizon=5, dt=0.01),
                               jnp.asarray(state0), jnp.asarray(controls)))
    got = rollout(cfg, torch.tensor(state0), torch.tensor(controls)).numpy()
    assert got.shape == (101, 4)
    assert np.allclose(got, ref, atol=1e-4)
    batched = rollout(cfg, torch.tensor(state0)[None].repeat(3, 1),
                      torch.tensor(controls)[None].repeat(3, 1, 1)).numpy()
    assert np.array_equal(batched[1], got)


@pytest.mark.parametrize("du0_w", [0.0, 1.0])
def test_residual_jacobian_matches_jacfwd(du0_w):
    """The sensitivities carried through the Euler recurrence equal
    ``jax.jacfwd`` of the JAX residuals, including controls on and beyond
    the bounds (where d clip = 1/2 and 0)."""
    cfg = MPCConfig(prediction_horizon=12, control_horizon=6, dt=0.05)
    jcfg = JMPCConfig(prediction_horizon=12, control_horizon=6, dt=0.05)
    rng = np.random.default_rng(1)
    u = (rng.standard_normal((6, 2)) * [3.0, 0.3]).astype(np.float32)
    u[1] = [7.0, -0.5]   # on the bounds
    u[2] = [9.0, 0.8]    # beyond them
    state = np.array([0.0, 0.0, 0.2, 5.0], np.float32)
    ref = np.stack([0.1 + 0.01 * np.arange(13), 5 + 0.1 * np.arange(13)], -1).astype(np.float32)
    last = np.array([0.5, 0.05], np.float32)
    rf = lambda uf: j_residuals(jcfg, uf.reshape(6, 2), jnp.asarray(state), jnp.asarray(ref),
                                jnp.asarray(last), du0_w)
    r_ref = np.asarray(rf(jnp.asarray(u.ravel())))
    J_ref = np.asarray(jax.jacfwd(rf)(jnp.asarray(u.ravel())))
    prob = _Problem(cfg, torch.device("cpu"))
    r, J = prob.residuals(torch.tensor(u)[None], torch.tensor(state)[None],
                          torch.tensor(ref)[None], torch.tensor(last)[None], du0_w, True)
    assert r.shape == (1, 2 * 13 + 12) and J.shape == (1, 2 * 13 + 12, 12)
    assert np.allclose(r[0].numpy(), r_ref, atol=1e-4)
    assert np.allclose(J[0].numpy(), J_ref, atol=1e-4 * np.abs(J_ref).max())


def test_initial_tracker_state():
    s = _initial_tracker_state(np.array([1.0, 2.0, -3.0, 3.0, 4.0]))
    assert np.isclose(s[2], -3.0 + 2 * np.pi) and np.isclose(s[3], 5.0)


def test_track_batch_matches_jax(windows_sce1):
    """States and controls of the port's batched tracker equal JAX
    ``track_batch`` on sce1 windows 1 and 3 at the validation config."""
    wps, inits = _window_paths(windows_sce1, (1, 3))
    t_j, s_j, c_j, n_j = j_track_batch(wps, inits, JMPCConfig(prediction_horizon=30,
                                                               control_horizon=20, dt=0.02))
    t_t, s_t, c_t, n_t = track_batch(wps, inits, MPCConfig(prediction_horizon=30,
                                                           control_horizon=20, dt=0.02),
                                     device="cpu")
    assert np.array_equal(n_j, n_t) and s_t.shape == s_j.shape and c_t.shape == c_j.shape
    assert s_t.shape[1] - 1 == -(-int(n_t.max()) // 64) * 64
    assert np.allclose(t_t, t_j)
    assert np.allclose(s_t, s_j, atol=1e-3)
    assert np.allclose(c_t, c_j, atol=1e-3)


def test_tracker_matches_slsqp_oracle(windows_sce1):
    """The SLSQP golden traces and bands of tests/test_mpc.py:124-148."""
    with open(FIXTURES / "oracle/sce1_start.json") as f:
        sc = json.load(f)
    cfg = MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02)
    wps, _ = _window_paths(windows_sce1, (1, 3))
    inits = np.array([[wp[0, 0], wp[0, 1], sc["angle"], sc["vx"], sc["vy"]] for wp in wps])
    _, states, controls, steps = track_batch(wps, inits, cfg, device="cpu")
    assert np.abs(controls[..., 0]).max() <= cfg.max_accel + 1e-6
    assert np.abs(controls[..., 1]).max() <= cfg.max_steer + 1e-6
    for b, idx in enumerate((1, 3)):
        ref = np.load(FIXTURES / f"oracle/ref_track_sce1w{idx}.npy")
        s = states[b, : steps[b] + 1]
        n = min(len(s), len(ref))
        pos = np.hypot(s[:n, 0] - ref[:n, 0], s[:n, 1] - ref[:n, 1])
        v = np.abs(s[:n, 3] - ref[:n, 3])
        assert pos.max() < 1.0, (idx, pos.max())
        assert pos.mean() < 0.4, (idx, pos.mean())
        assert v.mean() < 0.2, (idx, v.mean())
        err = PathReference(wps[b], inits[b]).position_error(
            np.arange(steps[b] + 1) * cfg.dt, s[:, :2])
        assert err.mean() < 0.75


def test_batch_matches_single(windows_sce1):
    cfg = MPCConfig(prediction_horizon=15, control_horizon=10, dt=0.02)
    wps, inits = _window_paths(windows_sce1, (1, 3))
    times_b, states_b, controls_b, steps = track_batch(wps, inits, cfg, device="cpu")
    for b in range(2):
        t_s, s_s, c_s = track(wps[b], inits[b], cfg, device="cpu")
        n = steps[b]
        assert n == len(s_s) - 1
        assert np.allclose(times_b[: n + 1], t_s)
        assert np.allclose(states_b[b, : n + 1], s_s, atol=1e-4)
        assert np.allclose(controls_b[b, :n], c_s, atol=1e-4)


def test_freeze_jacobian_tracks(windows_sce1):
    """The frozen-Jacobian Gauss-Newton option tracks a real window as the
    re-linearised solver does, within 5 cm (mpc.py:62-68 reports ≤ 1 cm)."""
    wps, inits = _window_paths(windows_sce1, (1,))
    base = MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02)
    frozen = MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02,
                       freeze_jacobian=True)
    _, s0, _, n = track_batch(wps, inits, base, device="cpu")
    _, s1, _, _ = track_batch(wps, inits, frozen, device="cpu")
    d = np.hypot(*(s0[0, : n[0] + 1, :2] - s1[0, : n[0] + 1, :2]).T)
    assert np.all(np.isfinite(s1)) and d.max() < 0.05


def test_control_horizon_guard():
    with pytest.raises(ValueError, match="control_horizon"):
        MPCConfig(prediction_horizon=5, control_horizon=6)
