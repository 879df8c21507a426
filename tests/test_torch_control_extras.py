"""The port's control edges and their commands against the JAX package, on
the CPU: the horizon sweep, the linear MPC, and ``cli.py mpc-sweep``,
``import``, ``export`` and ``doctor``.

Tolerances, float32 on both sides:
- the sweep's errors against JAX's: 1e-3 m (the batched tracker's states
  are held to JAX's at atol 1e-3, tests/test_torch_mpc.py);
- the linear MPC's states against JAX's ``simulate_tracking``: 1e-4 (the
  condensed problem sums in another order than JAX's sequential rollout;
  measured ≤ 1.1e-5 at 60 m over 350 closed-loop steps), its controls
  1e-3 (measured ≤ 1e-4); one solve's inputs 1e-5.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import REPO_ROOT
from defensive_model_vae_tpu.control import linear_mpc as JL
from defensive_model_vae_tpu.control.sweep import sweep_horizons as j_sweep_horizons

from defensive_model_vae_tpu_torch.cli import main
from defensive_model_vae_tpu_torch.control import (
    LinearMPCConfig, simulate_tracking, sine_road_demo, solve_ltv_qp, sweep_horizons)

SWEEP_TOL = 1e-3
STATES_TOL, CONTROLS_TOL, SOLVE_TOL = 1e-4, 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sce1_path(windows_sce1, i=1):
    wp = windows_sce1[i][:, [1, 2, 0]].astype(float)
    wp[0, 2] = 0.0
    v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
    return wp, np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])


def test_horizon_sweep_matches_jax(windows_sce1):
    """JAX tests/test_mpc.py:169, and each row's errors against JAX's."""
    wp, init = _sce1_path(windows_sce1)
    combos = ((10, 5), (20, 10))
    res = sweep_horizons(wp, init, combos=combos, dt=0.05, device="cpu")
    assert len(res) == 2
    for r in res:
        assert np.isfinite(r.max_error) and r.mean_error < 5.0
    for r, j in zip(res, j_sweep_horizons(wp, init, combos=combos, dt=0.05)):
        assert (r.prediction_horizon, r.control_horizon) == \
            (j.prediction_horizon, j.control_horizon)
        for f in ("max_error", "mean_error", "final_error"):
            assert abs(getattr(r, f) - getattr(j, f)) <= SWEEP_TOL, (f, r, j)


def test_solve_ltv_qp_matches_jax():
    cfg = LinearMPCConfig()
    rng = np.random.default_rng(0)
    x0 = np.array([0.3, -0.8, 2.0, 0.1], np.float32)
    s = np.linspace(0, 4, cfg.horizon + 1)
    x_ref = np.column_stack([s, 0.2 * s, np.full_like(s, 3.0),
                             rng.uniform(-0.2, 0.2, s.shape)]).astype(np.float32)
    u = solve_ltv_qp(cfg, x0, x_ref, 2.0, x_ref[0, 3], 0.05, device="cpu")
    ju = np.asarray(JL.solve_ltv_qp(JL.LinearMPCConfig(), x0, x_ref, np.float32(2.0),
                                    x_ref[0, 3], np.float32(0.05)))
    assert u.shape == (cfg.horizon, 2)
    np.testing.assert_allclose(u, ju, rtol=0, atol=SOLVE_TOL)
    assert np.all(np.abs(u) <= np.array([cfg.max_accel, cfg.max_steer], np.float32))


def test_linear_mpc_sine_road_matches_jax():
    """JAX tests/test_mpc.py:197's bounds, and the states against JAX's."""
    ref, states, controls = sine_road_demo(100, device="cpu")
    assert np.all(np.abs(controls[:, 0]) <= 1.0 + 1e-6)
    assert np.all(np.abs(controls[:, 1]) <= np.deg2rad(45) + 1e-6)
    err = [np.hypot(ref[:, 0] - p[0], ref[:, 1] - p[1]).min() for p in states[40:]]
    assert max(err) < 0.2
    assert states[-1, 2] > 1.5
    _, jstates, jcontrols = JL.sine_road_demo(100)
    np.testing.assert_allclose(states, jstates, rtol=0, atol=STATES_TOL)
    np.testing.assert_allclose(controls, jcontrols, rtol=0, atol=CONTROLS_TOL)


def _circle(rot):
    R, v, n = 60.0, 3.0, 700
    ang = np.linspace(-np.pi / 2, np.pi, n) + rot
    x, y = R * np.cos(ang), R * np.sin(ang)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    ref = np.column_stack([x, y, np.full(n, v), yaw]).astype(np.float32)
    return ref, np.array([x[0], y[0], v, yaw[0]], np.float32)


def _track_circle(rot):
    """→ (ref, x0, states, controls, the largest distance off the circle)."""
    ref, x0 = _circle(rot)
    states, controls = simulate_tracking(LinearMPCConfig(), ref, x0, 350, device="cpu")
    err = np.array([np.hypot(ref[:, 0] - p[0], ref[:, 1] - p[1]).min() for p in states])
    return ref, x0, states, controls, err.max()


@pytest.mark.parametrize("rot", [0.0, -np.pi / 2], ids=["seam", "clean"])
def test_linear_mpc_yaw_seam_matches_jax(rot):
    """JAX tests/test_mpc.py:422: through the ±π seam as tight as on the
    rotated circle, and the states against JAX's over 350 steps."""
    ref, x0, states, controls, err = _track_circle(rot)
    assert (np.abs(np.diff(ref[:, 3])).max() > np.pi) == (rot == 0.0)
    assert err < 0.5, err
    if rot == 0.0:
        assert abs(err - _track_circle(-np.pi / 2)[-1]) < 0.05
    jstates, jcontrols = JL.simulate_tracking(JL.LinearMPCConfig(), ref, x0, 350)
    np.testing.assert_allclose(states, np.asarray(jstates), rtol=0, atol=STATES_TOL)
    np.testing.assert_allclose(controls, np.asarray(jcontrols), rtol=0, atol=CONTROLS_TOL)


def test_control_edges_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref, x0 = _circle(0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_tracking(LinearMPCConfig(), ref, x0, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_horizons(np.zeros((3, 3)), np.zeros(5), combos=((2, 1),))


# ---- the commands ---------------------------------------------------------------

def test_cli_mpc_sweep(tmp_path, capsys):
    """JAX tests/test_cli.py:120."""
    t = np.arange(12) * 0.5
    wps = np.column_stack([np.full_like(t, -190.0), 20.0 + 10.0 * t, t])
    np.save(tmp_path / "wps.npy", wps)
    main(["mpc-sweep", "--waypoints", str(tmp_path / "wps.npy"),
          "--initial-state", "[-190.0, 20.0, 1.5708, 0.0, 10.0]",
          "--combos", "10:5,20:10", "--device", "cpu"])
    rows = json.loads(capsys.readouterr().out)
    assert [(r["P"], r["M"]) for r in rows] == [(10, 5), (20, 10)]
    for r in rows:
        assert r["max_error_m"] < 5.0


def test_cli_export_and_import(tmp_path, capsys):
    """JAX tests/test_cli.py:305, and the import back: the same params."""
    from defensive_model_vae_tpu.train.torch_import import load_torch_checkpoint as j_load

    from defensive_model_vae_tpu_torch.models import CVAEConfig
    from defensive_model_vae_tpu_torch.models import init_params
    from defensive_model_vae_tpu_torch.train import load_checkpoint, save_checkpoint

    cfg = CVAEConfig()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    d = save_checkpoint(str(tmp_path / "ck"), params, cfg, "sce1")
    pth = str(tmp_path / "vae_offset_sce1_ld8_epoch3000.pth")
    main(["export", "--ckpt", d, "--pth", pth])
    assert "exported" in capsys.readouterr().out
    _, jcfg = j_load(pth)
    assert (jcfg.seq_len, jcfg.dim, jcfg.hidden_dim) == (cfg.seq_len, cfg.dim, cfg.hidden_dim)
    main(["import", "--pth", pth, "--ckpt", str(tmp_path / "back"), "--device", "cpu"])
    assert "imported" in capsys.readouterr().out
    back, cfg2, manifest = load_checkpoint(str(tmp_path / "back"), "cpu")
    assert cfg2 == cfg and manifest["offset_mode"] is True and manifest["scenario"] == "sce1"
    assert all(torch.equal(back[k][n], params[k][n]) for k in params for n in ("w", "b"))


DOCTOR_ROWS = ("cuda backend", "device probe", "kernel build cache",
               "nvcc and kernel libraries", "csv loader", "dnda native kernels",
               "raw CARLA corpus", "fixture corpora", "checkpoints")


def test_cli_doctor_host_only(tmp_path, capsys):
    """``doctor --no-device``: every row reports, the native libraries
    build, and nothing that a host-only check may lack fails it."""
    main(["doctor", "--no-device", "--ckpt-root", str(REPO_ROOT / "results" / "checkpoints"),
          "--data-root", str(tmp_path / "none")])
    out = capsys.readouterr().out
    for row in DOCTOR_ROWS:
        assert row in out, row
    assert "FAIL" not in out and "skipped (--no-device)" in out
    assert "4/4 manifests readable" in out and "4 scenario corpora" in out
    assert "hash-seed" not in out


def test_cli_doctor_fails_without_a_card(tmp_path, capsys):
    """Without a CUDA device and without --no-device the backend row is a
    FAIL and the exit code 1 (JAX tests/test_pipeline.py:683)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(["doctor", "--ckpt-root", str(tmp_path / "x")])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert any(ln.startswith("FAIL  cuda backend") for ln in out.splitlines())
