"""The port's device reference and serve program against the JAX package,
on the CPU.

Tolerances:

- the not-a-knot spline: against scipy ``interp1d(kind="cubic")`` 5e-3
  over knots and extrapolation (float32, as ``tests/test_mpc.py:233``);
  against JAX's float32 spline 1e-4 of the values' scale (two float32
  LU solves of the same 10 × 10 system);
- the reference tensor [θ, v]: θ 1e-4 and v 0.05 against JAX's jitted
  ``build_reference_device`` and against the host ``PathReference``
  (``tests/test_mpc.py:248-249``);
- ``select_valid_trajectory``: exact (it only picks and repairs);
- ``make_serve_fn`` against JAX's on the same z: states and controls atol
  1e-3, the tolerance of a whole simulation (``tests/test_torch_mpc.py``);
- a row's result alone against the same row in a larger batch: exact
  for the draws; 1e-5 for the states (the CPU's batched products may
  pick another summation by batch width);
- at the deployment's size (sce4, 16 sce4 fixture starts, 512 steps, dt
  0.02, P = 30, M = 20, the port's draws for seed 5) against JAX's serve
  program built from its own parts on the same z: the waypoints 1e-4
  (measured 2.3e-5), the states 5e-3 (512 float32 steps compound the two
  programs' rounding: measured 9.3e-4), each row's mean position error
  against its own waypoints 5e-3 m; the rows at 2 m or more are the same
  on both sides, and row 0 is under 2 m (``tests/test_mpc.py:290``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from scipy.interpolate import interp1d

from conftest import REPO_ROOT
from defensive_model_vae_tpu.control import MPCConfig as JMPCConfig
from defensive_model_vae_tpu.control import device_reference as jdr
from defensive_model_vae_tpu.control.mpc import _simulate_batch_jit
from defensive_model_vae_tpu.models.cvae import decode, encode_condition
from defensive_model_vae_tpu.train.checkpoint import load_checkpoint as j_load

from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.control import MPCConfig, PathReference
from defensive_model_vae_tpu_torch.control import device_reference as dr
from defensive_model_vae_tpu_torch.generate import make_generate_fn
from defensive_model_vae_tpu_torch.models import sample
from defensive_model_vae_tpu_torch.pipeline import fixture_starts
from defensive_model_vae_tpu_torch.train.checkpoint import load_checkpoint

SCE1 = REPO_ROOT / "results" / "checkpoints" / "sce1"
SCE4 = REPO_ROOT / "results" / "checkpoints" / "sce4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _window_path(windows, idx):
    wp = windows[idx][:, [1, 2, 0]].astype(float)
    wp[0, 2] = 0.0
    v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
    return wp, np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])


def test_notaknot_spline_matches_scipy_and_jax():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, 10)) + np.arange(10) * 1e-3
    y = rng.normal(size=10) * 5
    q = np.linspace(t[0] - 1, t[-1] + 1, 300)
    f = interp1d(t, y, kind="cubic", bounds_error=False, fill_value="extrapolate")
    M = dr.notaknot_coeffs(_t(t)[None], _t(y)[None])
    mine = dr.cubic_eval(_t(t)[None], _t(y)[None], M, _t(q)[None])[0].numpy()
    assert np.abs(mine - f(q)).max() < 5e-3
    jM = jdr.notaknot_coeffs(jnp.asarray(t, jnp.float32), jnp.asarray(y, jnp.float32))
    jv = np.asarray(jdr.cubic_eval(jnp.asarray(t, jnp.float32), jnp.asarray(y, jnp.float32),
                                   jM, jnp.asarray(q, jnp.float32)))
    assert np.abs(mine - jv).max() < 1e-4 * np.abs(jv).max()
    # a batch of paths is each path on its own
    t2 = np.stack([t, t * 1.5 + 0.2])
    y2 = np.stack([y, -y])
    M2 = dr.notaknot_coeffs(_t(t2), _t(y2))
    both = dr.cubic_eval(_t(t2), _t(y2), M2, _t(np.stack([q, q])))
    np.testing.assert_allclose(both[0].numpy(), mine, atol=1e-5)


@pytest.mark.parametrize("idx", [1, 3])
def test_reference_matches_jax_and_host_on_fixture_windows(windows_sce1, idx):
    wp, init = _window_path(windows_sce1, idx)
    n = int(wp[-1, 2] / 0.02)
    host = PathReference(wp, init).build(n, 30, 0.02)
    jax_ref = np.asarray(jax.jit(lambda w, i: jdr.build_reference_device(w, i, n, 30, 0.02))(
        jnp.asarray(wp, jnp.float32), jnp.asarray(init, jnp.float32)))
    mine = dr.build_reference_device(_t(wp)[None], _t(init)[None], n, 30, 0.02)[0].numpy()
    assert mine.shape == host.shape == (n, 31, 2)
    for other in (jax_ref, host):
        assert np.abs(other[..., 0] - mine[..., 0]).max() < 1e-4  # θ
        assert np.abs(other[..., 1] - mine[..., 1]).max() < 0.05  # v


def _synthetic(kind):
    """A westbound path (headings near π, the −2.8 wrap) or one that stops
    (the low-speed heading hold)."""
    t = np.arange(10) * 1.0
    if kind == "westbound":
        x = -8.0 * t - 0.05 * t ** 2
        y = 0.3 * np.sin(t)
        init = np.array([x[0], y[0], np.pi - 0.01, -8.0, 0.0])
    else:
        speed = np.clip(5.0 - t, 0.0, None)
        x = np.zeros_like(t)
        y = np.concatenate([[0.0], np.cumsum(speed[:-1])])
        init = np.array([0.0, 0.0, np.pi / 2, 0.0, 5.0])
    return np.column_stack([x, y, t]), init


@pytest.mark.parametrize("kind", ["westbound", "stop"])
def test_reference_matches_host_on_wrap_and_low_speed_hold(kind):
    wp, init = _synthetic(kind)
    n = int(wp[-1, 2] / 0.05) + 20  # past the end: the extrapolation too
    host = PathReference(wp, init).build(n, 12, 0.05)
    mine = dr.build_reference_device(_t(wp)[None], _t(init)[None], n, 12, 0.05)[0].numpy()
    jax_ref = np.asarray(jdr.build_reference_device(
        jnp.asarray(wp, jnp.float32), jnp.asarray(init, jnp.float32), n, 12, 0.05))
    if kind == "stop":
        assert (host[..., 1] < 0.1).any()  # the hold is exercised
    else:
        assert (host[..., 0] > 2.8).any()  # headings wrapped past π
    for other in (jax_ref, host):
        assert np.abs(other[..., 0] - mine[..., 0]).max() < 1e-4
        assert np.abs(other[..., 1] - mine[..., 1]).max() < 0.05


_T = 6
_GOOD = np.column_stack([np.arange(_T) * 0.5, np.arange(_T), np.ones(_T)])
_BAD = _GOOD.copy()
_BAD[:, 0] = [0.0, 0.4, 0.3, 0.9, 1.2, 1.5]  # non-monotone time
_SHIFTED = _GOOD.copy()
_SHIFTED[:, 0] = 0.5 + np.arange(_T) * 0.5  # valid only once t0 is zeroed


@pytest.mark.parametrize("case", ["first_valid", "all_bad", "single", "t0_zeroed"])
def test_select_valid_trajectory(case):
    """The four cases of tests/test_mpc.py:296-330, each against JAX, and
    batched with the other cases' rows (rows are independent)."""
    cands = {"first_valid": [_BAD, _BAD, _GOOD, _GOOD], "all_bad": [_BAD, _BAD],
             "single": [_GOOD], "t0_zeroed": [_BAD, _SHIFTED]}[case]
    stack = np.stack(cands).astype(np.float32)
    out = dr.select_valid_trajectory(_t(stack)[None])[0].numpy()
    np.testing.assert_array_equal(out, np.asarray(jdr.select_valid_trajectory(stack)))
    expect = _GOOD.copy()
    expect[0, 0] = 0.0
    if case in ("first_valid", "single"):
        assert np.allclose(out, expect)
    elif case == "all_bad":
        assert np.all(np.diff(out[:, 0]) > 0) and np.allclose(out[:, 1:], _BAD[:, 1:])
    else:
        assert out[0, 0] == 0.0 and np.all(np.diff(out[:, 0]) > 0)
        assert np.allclose(out[:, 1:], _SHIFTED[:, 1:])
    other = np.stack([_GOOD] * len(cands)).astype(np.float32)
    batched = dr.select_valid_trajectory(_t(np.stack([other, stack])))[1].numpy()
    np.testing.assert_array_equal(batched, out)


def _jax_draws(key, B):
    """z as JAX's serve program draws it: split(key, B), then _N_DRAWS
    subkeys a row (tests/test_mpc.py:283-286)."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(k, (1, 8), jnp.float32))[0]
                  for k in jax.random.split(kb, jdr._N_DRAWS)])
        for kb in jax.random.split(key, B)])


@pytest.fixture(scope="module")
def sce1_both():
    jp, jcfg, _ = j_load(str(SCE1))
    tp, tcfg, _ = load_checkpoint(str(SCE1), "cpu")
    return jp, jcfg, tp, tcfg


@pytest.mark.parametrize("offset_mode", [True, False])
def test_serve_fn_matches_jax_on_the_same_z(windows_sce1, sce1_both, offset_mode):
    jp, jcfg, tp, tcfg = sce1_both
    starts, inits = fixture_starts(windows_sce1[:3])
    starts, inits = starts.astype(np.float32), inits.astype(np.float32)
    S = 24
    j_serve = jdr.make_serve_fn(jp, jcfg, JMPCConfig(prediction_horizon=8, control_horizon=5,
                                                     dt=0.1), num_steps=S,
                                offset_mode=offset_mode)
    key = jax.random.PRNGKey(5)
    s_j, c_j = j_serve(key, jnp.asarray(starts), jnp.asarray(inits))
    serve = dr.make_serve_fn(tp, tcfg, MPCConfig(prediction_horizon=8, control_horizon=5,
                                                 dt=0.1), S, offset_mode=offset_mode)
    s_t, c_t = serve(0, starts, inits, z=_jax_draws(key, 3))
    assert s_t.shape == (3, S + 1, 4) and c_t.shape == (3, S, 2)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-3)


def test_serve_rows_depend_only_on_seed_and_index(windows_sce1, sce1_both):
    """The port's own draws: a row's z depends only on (seed, row), so a
    row alone equals the same row of a larger batch; the served states
    track their selected waypoints (tests/test_mpc.py:290)."""
    _, _, tp, tcfg = sce1_both
    z5 = dr.request_draws(7, 5, dr._N_DRAWS, 8, "cpu")
    assert torch.equal(dr.request_draws(7, 2, dr._N_DRAWS, 8, "cpu"), z5[:2])
    assert not torch.equal(dr.request_draws(8, 2, dr._N_DRAWS, 8, "cpu"), z5[:2])
    starts, inits = fixture_starts(windows_sce1[:3])
    mpc = MPCConfig(prediction_horizon=15, control_horizon=10, dt=0.1)
    serve = dr.make_serve_fn(tp, tcfg, mpc, 80)
    s3, _ = serve(7, starts, inits)
    s1, _ = serve(7, starts[:1], inits[:1])
    assert torch.isfinite(s3).all()
    np.testing.assert_allclose(s1[0].numpy(), s3[0].numpy(), atol=1e-5)
    cands = sample(tp, None, torch.as_tensor(starts[:1]).repeat(dr._N_DRAWS, 1), tcfg,
                   z=z5[0])
    traj = dr.select_valid_trajectory(cands[None])[0].numpy().astype(float)
    wp = traj[:, [1, 2, 0]]
    n = min(81, int(wp[-1, 2] / mpc.dt) + 1)
    err = PathReference(wp, inits[0]).position_error(np.arange(n) * mpc.dt,
                                                     s3[0, :n, :2].numpy())
    assert err.mean() < 2.0


def _mean_position_errors(wp, inits, states, dt):
    """Each row's mean distance from its own waypoints' path over the
    path's duration (tests/test_mpc.py:286-290)."""
    out = []
    for b in range(len(wp)):
        n = min(states.shape[1], int(wp[b, -1, 2] / dt) + 1)
        ref = PathReference(wp[b], inits[b].astype(float))
        out.append(float(ref.position_error(np.arange(n) * dt, states[b, :n, :2]).mean()))
    return np.array(out)


def test_served_rows_track_as_jax_at_the_deployment_size():
    """The serve phase's request on the CPU: its 16 rows through the port
    and through JAX's serve program (decode with the same z, JAX's
    select_valid_trajectory, build_reference_device and _simulate), and
    each row's tracking error on both sides."""
    B, S, P, M, dt, seed = 16, 512, 30, 20, 0.02, 5
    starts, inits = fixture_starts(np.load(scenarios.get("sce4").fixture_windows)[:B])
    starts, inits = starts.astype(np.float32), inits.astype(np.float32)
    jp, jcfg, _ = j_load(str(SCE4))
    tp, tcfg, _ = load_checkpoint(str(SCE4), "cpu")
    z = dr.request_draws(seed, B, dr._N_DRAWS, tcfg.latent_dim, "cpu")
    s_t, _ = dr.make_serve_fn(tp, tcfg, MPCConfig(prediction_horizon=P, control_horizon=M,
                                                  dt=dt), S)(seed, starts, inits)
    cands = sample(tp, None, torch.as_tensor(starts).repeat_interleave(dr._N_DRAWS, 0),
                   tcfg, z=z.reshape(-1, tcfg.latent_dim))
    wp_t = dr.select_valid_trajectory(cands.reshape(B, dr._N_DRAWS, tcfg.seq_len, tcfg.dim))
    wp_t = wp_t.numpy()[..., [1, 2, 0]].astype(float)

    def one(zb, s, init):
        rel = decode(jp, zb, encode_condition(jp, jnp.broadcast_to(s, (zb.shape[0], 2))), jcfg)
        tr = jdr.select_valid_trajectory(rel.at[:, :, 1:3].add(s))
        wp = jnp.stack([tr[:, 1], tr[:, 2], tr[:, 0]], axis=1)
        return wp, jdr.build_reference_device(wp, init, S, P, dt)

    wp_j, refs = jax.jit(jax.vmap(one))(jnp.asarray(z.numpy()), jnp.asarray(starts),
                                        jnp.asarray(inits))
    theta = np.where(inits[:, 2] < -2.8, inits[:, 2] + 2 * np.pi, inits[:, 2])
    s0 = np.stack([inits[:, 0], inits[:, 1], theta, np.hypot(inits[:, 3], inits[:, 4])], 1)
    s_j, _ = _simulate_batch_jit(JMPCConfig(prediction_horizon=P, control_horizon=M, dt=dt),
                                 jnp.asarray(s0, jnp.float32), refs, jnp.zeros((B, 2)))
    wp_j, s_j = np.asarray(wp_j).astype(float), np.asarray(s_j)
    assert np.abs(wp_t - wp_j).max() < 1e-4
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=5e-3)
    err_t = _mean_position_errors(wp_t, inits, s_t.numpy(), dt)
    err_j = _mean_position_errors(wp_j, inits, s_j, dt)
    np.testing.assert_allclose(err_t, err_j, atol=5e-3)
    assert err_t[0] < 2.0 and err_j[0] < 2.0
    # the rows whose fixture speed runs ahead of their sampled path stay
    # 2 m or more from it in both programs
    assert set(np.flatnonzero(err_t >= 2.0)) == set(np.flatnonzero(err_j >= 2.0)) == {1, 10, 13}


def test_generate_fn_draws_by_row_and_honours_offset_mode(sce1_both):
    _, _, tp, tcfg = sce1_both
    starts = np.array([[-193.3, 50.0], [-192.8, 42.0], [-190.0, 44.0]], np.float32)
    shifted = make_generate_fn(tp, tcfg, True)
    a = shifted(11, starts)
    assert a.shape == (3, tcfg.seq_len, tcfg.dim) and torch.isfinite(a).all()
    np.testing.assert_allclose(shifted(11, starts[:1])[0].numpy(), a[0].numpy(), atol=1e-5)
    z = dr.request_draws(11, 3, 1, 8, "cpu")[:, 0]
    absolute = make_generate_fn(tp, tcfg, False)(11, starts)
    # the legacy decoder skips the start shift, and only that
    np.testing.assert_allclose(a[:, :, 1:3].numpy() - starts[:, None, :],
                               absolute[:, :, 1:3].numpy(), atol=1e-4)
    np.testing.assert_allclose(shifted(0, starts, z=z).numpy(), a.numpy(), atol=0)


def test_serve_fn_refusals(sce1_both):
    _, _, tp, tcfg = sce1_both
    with pytest.raises(ValueError, match="wrapped jump-guard only"):
        dr.make_serve_fn(tp, tcfg, MPCConfig(raw_jump_guard=True), 4)
    with pytest.raises(TypeError, match="create_mesh"):
        dr.make_serve_fn(tp, tcfg, MPCConfig(), 4, mesh=object())
    serve = dr.make_serve_fn(tp, tcfg, MPCConfig(prediction_horizon=5, control_horizon=3,
                                                 dt=0.1), 4)
    with pytest.raises(ValueError, match="z has shape"):
        serve(0, np.zeros((2, 2)), np.zeros((2, 5)), z=np.zeros((2, 4, 8)))
