"""The port's mesh over ``torch.distributed`` against the JAX package's
``parallel/`` (tests/test_parallel.py), on the CPU.

The port's side runs in spawned gloo worlds (``parallel.spawn_world``: a
``file://`` rendezvous in a temporary directory, every world under a time
limit, so a failing rank fails its test instead of hanging the suite); the
JAX side in this process on the suite's 8 virtual CPU devices.  The cheap
checks that share inputs share one world (a module fixture) and keep a test
function each.

Tolerances are JAX's own: parameters atol 1e-5, the scan trainer's metrics
rtol 1e-5, tracked states atol 1e-5 (mesh against one device; 1e-3 against
JAX's tracker, the tracker's parity tolerance of tests/test_torch_mpc.py),
the DNDA sweep index for index.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import optax

from conftest import straight_rect_sweep
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.parallel import create_mesh as j_create_mesh
from defensive_model_vae_tpu.parallel import shard_batch as j_shard_batch
from defensive_model_vae_tpu_torch.control import MPCConfig, track_batch
from defensive_model_vae_tpu_torch.dnda import core as tcore
from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.parallel import spawn_world, start_world, worlds
from defensive_model_vae_tpu_torch.train import (TrainConfig, init_opt_state,
                                                 make_train_step, train,
                                                 train_conditioned)
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

WORLD_S = 180.0  # each world's time limit
TRAIN = "defensive_model_vae_tpu_torch.train:train"
MPC = MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05)


def _np_params(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _track_inputs(windows):
    """tests/test_parallel.py:111-121's four sce1 paths and their starts."""
    wps, inits = [], []
    for i in (1, 3, 5, 6):
        wp = windows[i][:, [1, 2, 0]].astype(np.float64)
        wp[0, 2] = 0.0
        v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
        wps.append(wp)
        inits.append([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
    return np.stack(wps), np.asarray(inits)


def _sweep_preps(n=17):
    """tests/test_parallel.py:136-150's frames."""
    rng = np.random.default_rng(3)
    return [tcore.FramePrep(
        ego_rects=[straight_rect_sweep(60, 0.0), straight_rect_sweep(50, 0.0)],
        usable=[0, 1], unit_arc_paths=[1.0, 1.2], k_maxes=[0.01, 0.02],
        sur_array=np.array([[float(rng.uniform(5, 40)), 0.0, 4.0, 2.0,
                             float(rng.uniform(-2, 2)), 0.0, 0.0, 0.0, 0.0]]),
        ego_speed=float(rng.uniform(4, 12)), time_horizon=3.0, time_step=0.1)
        for _ in range(n)]


def _tp_inputs(windows):
    from defensive_model_vae_tpu.models import to_relative

    rel, starts = to_relative(jnp.asarray(windows[:8], jnp.float32))
    eps = jax.random.normal(jax.random.PRNGKey(3), (8, 8), jnp.float32)
    params = _np_params(j_init_params(jax.random.PRNGKey(0), JCVAEConfig()))
    return params, np.asarray(rel), np.asarray(starts), np.asarray(eps)


@pytest.fixture(scope="module")
def world4(windows_sce1):
    """One world of four gloo ranks running every check of this module that
    needs four: the mesh facts, the scan trainer, the tracker, the DNDA sweep
    and the tensor-parallel forward."""
    wps, inits = _track_inputs(windows_sce1)
    calls = [
        (worlds.mesh_facts, (13,), {}),
        (worlds.call_with_mesh, (TRAIN, windows_sce1[:32]),
         {"train_cfg": TrainConfig(epochs=50)}),
        (worlds.call_with_mesh, (TRAIN, np.asarray(windows_sce1[:6])),
         {"train_cfg": TrainConfig(epochs=20, seed=0)}),
        (worlds.call_with_mesh,
         ("defensive_model_vae_tpu_torch.control.mpc:track_batch", wps, inits, MPC), {}),
        (worlds.call_with_mesh,
         ("defensive_model_vae_tpu_torch.dnda.core:sweep_frames", _sweep_preps()), {}),
        (worlds.tensor_parallel_forward, _tp_inputs(windows_sce1) + ((2, 2),), {}),
    ]
    out = spawn_world(worlds.run_all, 4, "gloo", "cpu", args=(calls,), timeout_s=WORLD_S)
    keys = ("facts", "train50", "train6", "track", "sweep", "tp")
    return [dict(zip(keys, r)) for r in out]


@pytest.fixture(scope="module")
def world2(windows_sce1):
    """One world of two: a make_parallel_train_step step (the JAX test's 32
    rows, and 7 rows padded to 8 and masked), and train_conditioned."""
    params = _np_params(j_init_params(jax.random.PRNGKey(0), JCVAEConfig()))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (32, 8), jnp.float32))
    extra = np.eye(4, dtype=np.float32)[np.arange(12) % 4]
    calls = [
        (worlds.train_step, (params, eps, windows_sce1[:32]), {}),
        (worlds.train_step, (params, eps[:7], windows_sce1[:7]),
         {"mask": np.ones(7, np.float32)}),
        (worlds.call_with_mesh,
         ("defensive_model_vae_tpu_torch.train:train_conditioned", windows_sce1[:12],
          extra, TrainConfig(epochs=20)), {}),
    ]
    out = spawn_world(worlds.run_all, 2, "gloo", "cpu", args=(calls,), timeout_s=WORLD_S)
    return [dict(zip(("step32", "step7", "conditioned"), r)) for r in out], params, eps


# ---- create_mesh, shard_batch, replicate (test_parallel.py:22-45) ------------------

def test_mesh_shapes_and_refusals(world4):
    j4 = j_create_mesh(shape=(4, 1))
    for r, res in enumerate(world4):
        f = res["facts"]
        assert f["shape"] == dict(j4.shape) == {"data": 4, "model": 1}
        assert f["size"] == j4.devices.size and f["coordinate"] == (r, 0)
        assert f["two_by"] == dict(j_create_mesh(shape=(2, 2)).shape)
        # a smaller mesh takes a prefix of the ranks, as JAX takes a device prefix
        assert f["prefix"] == ((0, r) if r < 2 else None)
        assert f["errors"] == ["need 8 devices, have 4", "mesh shape (1, 3) != 4 devices"]
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        j_create_mesh(shape=(8, 2))


def test_shard_batch_pads_and_blocks_as_jax(world4):
    batch = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    sharded = j_shard_batch(jnp.asarray(batch), j_create_mesh(shape=(4, 1)))
    assert sharded.shape[0] == 16
    by_device = {s.device.id: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, res in enumerate(world4):
        assert res["facts"]["padded"] == 16
        np.testing.assert_array_equal(res["facts"]["block"], by_device[r])
        np.testing.assert_array_equal(res["facts"]["gathered"], np.asarray(sharded))


def test_replicate_takes_rank_zero(world4):
    for res in world4:
        np.testing.assert_array_equal(res["facts"]["replicated"], np.zeros((2, 2)))


# ---- make_train_step and make_parallel_train_step (test_parallel.py:47-79) ---------

def test_make_train_step_matches_jax_step(windows_sce1):
    """One epoch of the port's step against JAX's ``make_train_step`` on one
    device, from JAX's init, on the noise JAX's key draws."""
    from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
    from defensive_model_vae_tpu.train import make_train_step as j_make_train_step

    opt = optax.adam(1e-3)
    jstep = j_make_train_step(JCVAEConfig(), JTrainConfig(epochs=1), opt)
    jp = j_init_params(jax.random.PRNGKey(0), JCVAEConfig())
    key = jax.random.PRNGKey(7)
    batch = windows_sce1[:32]
    jp1, _, jm = jax.jit(jstep)(jp, opt.init(jp), key, jnp.asarray(batch))
    eps = torch.as_tensor(np.array(jax.random.normal(key, (32, 8), jnp.float32)))
    p = params_from_numpy(_np_params(jp), "cpu")
    step = make_train_step(CVAEConfig(), TrainConfig(epochs=1))
    p1, st, m = step(p, init_opt_state(p), eps, torch.as_tensor(batch))
    assert st["count"] == 1
    for k in jm:
        assert np.isclose(float(jm[k]), float(m[k]), rtol=1e-5), k
    for name in jp:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(p1[name][leaf].numpy(), np.asarray(jp1[name][leaf]),
                                       atol=1e-5, err_msg=f"{name}.{leaf}")


def test_parallel_step_matches_single_device(world2, windows_sce1):
    """A make_parallel_train_step step over 2 ranks equals the one-device
    step, every metric and every leaf, on both ranks; 7 rows (one pad row,
    masked) as 7 rows on one device."""
    res, params, eps = world2
    step = make_train_step(CVAEConfig(), TrainConfig())
    for rows, key in ((32, "step32"), (7, "step7")):
        p = params_from_numpy(params, "cpu")
        p1, _, m = step(p, init_opt_state(p), torch.as_tensor(eps[:rows]),
                        torch.as_tensor(windows_sce1[:rows]))
        for r in res:
            got_p, got_m = r[key]
            for k in m:
                assert np.isclose(got_m[k], float(m[k]), rtol=1e-5), (key, k)
            for name in p1:
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(got_p[name][leaf], p1[name][leaf].numpy(),
                                               atol=1e-5, err_msg=f"{key} {name}.{leaf}")


# ---- tensor parallelism (test_parallel.py:81-98) -----------------------------------

def test_tensor_parallel_forward_matches(world4, windows_sce1):
    """DTensor params sharded over a (2, 2) mesh's model axis give the
    unsharded forward, and JAX's forward on the same noise."""
    from defensive_model_vae_tpu.models.cvae import decode as j_decode
    from defensive_model_vae_tpu.models.cvae import encode as j_encode

    params, rel, starts, eps = _tp_inputs(windows_sce1)
    mu, lv, hc = j_encode(params, jnp.asarray(rel), jnp.asarray(starts))
    ref = np.asarray(j_decode(params, mu + eps * jnp.exp(0.5 * lv), hc, JCVAEConfig()))
    for res in world4:
        recon, plain, placements = res["tp"]
        np.testing.assert_allclose(recon, plain, atol=1e-5)
        np.testing.assert_allclose(recon, ref, atol=1e-5)
        # the first 128-wide axis of each leaf is sharded, as JAX's spec_for
        assert placements["enc_1.w"] == "S(0)" and placements["cond_0.w"] == "S(1)"
        assert placements["enc_1.b"] == "S(0)" and placements["fc_mu.w"] == "R"


# ---- the scan trainer over the mesh (test_parallel.py:101-104, :162-178) -----------

def test_train_with_mesh(world4, windows_sce1):
    """Trains over four ranks, descends, and equals the one-device run."""
    _, h1 = train(windows_sce1[:32], train_cfg=TrainConfig(epochs=50), device="cpu")
    for res in world4:
        _, hist = res["train50"]
        assert hist["total"][0] / hist["total"][-1] > 2
        np.testing.assert_allclose(hist["total"], h1["total"], rtol=1e-5)
    np.testing.assert_array_equal(world4[0]["train50"][1]["total"],
                                  world4[3]["train50"][1]["total"])


def test_mesh_training_matches_unpadded_objective(world4, windows_sce1):
    """6 rows on 4 ranks pad to 8; the pad rows are masked, so the run
    trains the same objective as the one-device full batch."""
    p1, h1 = train(np.asarray(windows_sce1[:6]), train_cfg=TrainConfig(epochs=20, seed=0),
                   device="cpu")
    for res in world4:
        params, hist = res["train6"]
        for k in h1:
            np.testing.assert_allclose(hist[k], h1[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for name in p1:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(params[name][leaf], p1[name][leaf].numpy(),
                                           atol=1e-5)


def test_train_conditioned_with_mesh(world2, windows_sce1):
    extra = np.eye(4, dtype=np.float32)[np.arange(12) % 4]
    _, h1, cfg1 = train_conditioned(windows_sce1[:12], extra, TrainConfig(epochs=20),
                                    device="cpu")
    for r in world2[0]:
        _, hist, cfg = r["conditioned"]
        assert cfg == cfg1 and cfg.cond_dim == 6
        for k in h1:
            np.testing.assert_allclose(hist[k], h1[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ---- the tracker and the DNDA sweep (test_parallel.py:107-160) ---------------------

def test_track_batch_over_mesh_matches(world4, windows_sce1):
    from defensive_model_vae_tpu.control import MPCConfig as JMPCConfig
    from defensive_model_vae_tpu.control import track_batch as j_track_batch

    wps, inits = _track_inputs(windows_sce1)
    _, states1, controls1, steps1 = track_batch(wps, inits, MPC, device="cpu")
    _, j_states, _, _ = j_track_batch(
        wps, inits, JMPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05),
        mesh=j_create_mesh(shape=(4, 1)))
    for res in world4:
        _, states, controls, steps = res["track"]
        assert states.shape == states1.shape and np.array_equal(steps, steps1)
        np.testing.assert_allclose(states, states1, atol=1e-5)
        np.testing.assert_allclose(controls, controls1, atol=1e-5)
        np.testing.assert_allclose(states, j_states, atol=1e-3)


def test_dnda_sweep_sharded_over_mesh(world4):
    """17 frames over 4 ranks (blocks of 4 and 5): index for index the
    one-device sweep, the numpy oracle and JAX's sharded sweep."""
    from defensive_model_vae_tpu.dnda.core import FramePrep as JFramePrep
    from defensive_model_vae_tpu.dnda.core import sweep_frames as j_sweep_frames

    preps = _sweep_preps()
    host = tcore.sweep_frames(preps, host=True)
    single = tcore.sweep_frames(preps, device="cpu")
    jax_sharded = j_sweep_frames([JFramePrep(**vars(p)) for p in preps], device=True,
                                 mesh=j_create_mesh())
    for res in world4:
        assert len(res["sweep"]) == len(preps)
        for h, s, d, j in zip(host, res["sweep"], single, jax_sharded):
            assert np.array_equal(h, s) and np.array_equal(s, d) and np.array_equal(s, j)


def test_world_failure_and_time_limit_are_reported(windows_sce1):
    """A rank that raises fails the call with its traceback; a world that
    outlives its limit is terminated and raises TimeoutError."""
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        spawn_world(worlds.call_with_mesh, 2, "gloo", "cpu",
                    args=("defensive_model_vae_tpu_torch.train:train", None),
                    timeout_s=60.0)
    with pytest.raises(TimeoutError, match="still running"):
        spawn_world(worlds.dp_timed, 2, "gloo", "cpu", args=(windows_sce1,),
                    kwargs={"epochs": 10 ** 6, "tile": 8, "compute_dtype": None},
                    timeout_s=5.0)


def test_a_world_started_early_waits_for_its_call():
    """``start_world`` returns at once; its ranks join their group and wait,
    idle, for the call ``submit`` gives them; ``close`` ends a world that
    gets none."""
    world = start_world(2, "gloo", "cpu", timeout_s=60.0)
    world.submit(worlds.gloo_cuda_probe)
    out = world.result()
    assert [r["all_reduce"] for r in out] == ["ok", "ok"]
    assert all(world.started <= r["entry"] <= r["joined"] <= r["called"] for r in out)
    idle = start_world(2, "gloo", "cpu", timeout_s=60.0)
    idle.close()
    assert not any(p.is_alive() for p in idle.procs)
