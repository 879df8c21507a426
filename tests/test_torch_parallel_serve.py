"""The port's data-parallel trainer tier, serve program and server against
the JAX package (tests/test_fused_scale.py:487-580, tests/test_parallel.py
:182-213, tests/test_serving.py:199-225), and the CLI's ``train --mesh`` and
``serve --data-parallel``, on the CPU.

The port runs in spawned gloo worlds (``parallel.spawn_world``, each under a
time limit); JAX's ``fused_train_scale_dp`` on its (4, 1) mesh of the
suite's virtual CPU devices in interpret mode with explicit ε, the port's
through K4's plain version.  Tolerances are JAX's: parameters atol 1e-5,
the history rtol 1e-4 / atol 1e-5, served states and controls atol 1e-5.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import REPO_ROOT
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.ops import fused_scale as jfs
from defensive_model_vae_tpu.parallel import create_mesh as j_create_mesh
from defensive_model_vae_tpu_torch.control import MPCConfig
from defensive_model_vae_tpu_torch.control.device_reference import make_serve_fn
from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights
from defensive_model_vae_tpu_torch.ops import fused_scale as tfs
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.parallel import spawn_world, worlds
from defensive_model_vae_tpu_torch.serving import build_generate_fn
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

WORLD_S = 180.0
DP = "defensive_model_vae_tpu_torch.ops.fused_scale:fused_train_scale_dp"
CKPT = REPO_ROOT / "results" / "checkpoints" / "sce2"
KEYS = ("total", "recon", "kld", "start", "time")
MPC = MPCConfig(prediction_horizon=5, control_horizon=3, dt=0.1)


def _tiny_corpus(n, seed):
    """The corpus of tests/test_fused_scale.py:27."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, 10)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, 10, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def _jax_init():
    return jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                            JCVAEConfig()))


def _eps(n, key):
    return np.array(jax.random.normal(jax.random.PRNGKey(key), (n, 8)))


def _serve_inputs(b=8):
    rng = np.random.default_rng(3)
    starts = rng.normal(0, 1, (b, 2)).astype(np.float32)
    inits = np.concatenate([rng.normal(0, 1, (b, 3)), np.full((b, 1), 5.0),
                            np.zeros((b, 1))], axis=1).astype(np.float32)
    return starts, inits


def _hist(h):
    return np.stack([h[k] for k in KEYS], 1)


def _assert_params(a, b, atol=1e-5):
    for x, y in zip(tft._flatten_params(a), tft._flatten_params(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One world of four gloo ranks: the dp tier on 64 rows (one tile a
    rank, as JAX's test), on 48 ragged rows (padded to 64) and in bf16; the
    serve program and the sampler over the batch."""
    init = _jax_init()
    w64, w48 = _tiny_corpus(64, 13), _tiny_corpus(48, 17)
    starts, inits = _serve_inputs()
    calls = [
        (worlds.dp_from, (init, w64), dict(epochs=3, tile=8, compute_dtype=None,
                                           eps=_eps(64, 3))),
        (worlds.dp_from, (init, w48), dict(epochs=2, tile=8, compute_dtype=None,
                                           eps=_eps(48, 5))),
        (worlds.call_with_mesh, (DP, w64),
         dict(epochs=6, tile=16, compute_dtype="bfloat16", eps=_eps(64, 9))),
        (worlds.serve_program, (init, MPC, 6, 9, starts, inits), {}),
        (worlds.generate_program, (str(CKPT), 3, starts), {}),
    ]
    out = spawn_world(worlds.run_all, 4, "gloo", "cpu", args=(calls,), timeout_s=WORLD_S)
    return [dict(zip(("dp64", "dp48", "bf16", "serve", "gen"), r)) for r in out]


# ---- fused_train_scale_dp over the mesh (test_fused_scale.py:487-580) --------------

def test_scale_dp_matches_jax_on_its_mesh(world4):
    """Four ranks against JAX's (4, 1) mesh, the same init and ε."""
    w, eps = _tiny_corpus(64, 13), _eps(64, 3)
    jp, jh = jfs.fused_train_scale_dp(w, mesh=j_create_mesh(shape=(4, 1)), epochs=3,
                                      tile=8, compute_dtype=None, eps=eps,
                                      interpret=True)
    for res in world4:
        params, hist = res["dp64"]
        _assert_params(params, jax.tree_util.tree_map(np.asarray, jp))
        np.testing.assert_allclose(_hist(hist), _hist(jh), rtol=1e-4, atol=1e-5)


def test_scale_dp_matches_oracle_and_one_device(world4):
    """Four ranks against the port's mesh=None run and the oracle
    ``fused_scale_reference`` from the same init (the port's oracle is held
    to JAX's in tests/test_torch_fused_scale.py)."""
    init, w, eps = _jax_init(), _tiny_corpus(64, 13), _eps(64, 3)
    p1, h1 = tfs.fused_train_scale_dp(w, epochs=3, tile=8, compute_dtype=None, eps=eps,
                                      device="cpu",
                                      _init_params=params_from_numpy(init, "cpu"))
    pr, hr = tfs.fused_scale_reference(params_from_numpy(init, "cpu"), w, eps, epochs=3)
    for res in world4:
        params, hist = res["dp64"]
        for ref_p, ref_h in ((p1, _hist(h1)), (pr, hr)):
            _assert_params(params, jax.tree_util.tree_map(
                lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                ref_p))
            np.testing.assert_allclose(_hist(hist), np.asarray(ref_h), rtol=1e-4,
                                       atol=1e-5)


def test_scale_dp_sharded_equals_single_device_ragged(world4):
    """48 rows over 4 ranks × tile 8 pad to 64: the masked pad rows leave
    the objective the one-device run's."""
    init, w, eps = _jax_init(), _tiny_corpus(48, 17), _eps(48, 5)
    p1, h1 = tfs.fused_train_scale_dp(w, epochs=2, tile=8, compute_dtype=None, eps=eps,
                                      device="cpu",
                                      _init_params=params_from_numpy(init, "cpu"))
    jp, jh = jfs.fused_train_scale_dp(w, mesh=j_create_mesh(shape=(4, 1)), epochs=2,
                                      tile=8, compute_dtype=None, eps=eps, interpret=True)
    for res in world4:
        params, hist = res["dp48"]
        _assert_params(params, {k: {n: a.numpy() for n, a in v.items()}
                                for k, v in p1.items()})
        np.testing.assert_allclose(_hist(hist), _hist(h1), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_hist(hist), _hist(jh), rtol=1e-4, atol=1e-5)


def test_scale_dp_bf16_descends_on_mesh(world4):
    for res in world4:
        params, hist = res["bf16"]
        assert np.all(np.isfinite(hist["total"])) and hist["total"][-1] < hist["total"][0]
        for p in tft._flatten_params(params):
            assert p.dtype == np.float32 and np.all(np.isfinite(p))
    np.testing.assert_array_equal(world4[0]["bf16"][1]["total"], world4[3]["bf16"][1]["total"])


def _dp_by_hand(w, noise, epochs, tile, dp, seed=0):
    """The dp tier emulated in one process: rank d's block, rank d's noise
    stream (prng base seed + (d·epochs + e)·local_tiles, hbm stream d·epochs
    + e), the blocks' gradients summed, Adam."""
    cfg, lw = CVAEConfig(), LossWeights()
    n, packed = tfs._scale_inputs(w, cfg, tile, None, None, torch.device("cpu"), dp * tile)
    per = packed.shape[0] // dp
    from defensive_model_vae_tpu_torch.models import init_params

    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(seed), cfg, "cpu"))
    m = [torch.zeros_like(a) for a in plist]
    v = [torch.zeros_like(a) for a in plist]
    hist = []
    for e in range(epochs):
        total_g, total_row = None, None
        for d in range(dp):
            blk = packed[d * per:(d + 1) * per]
            stream = d * epochs + e
            eps_e = None
            if noise == "hbm":
                eps_e = torch.randn((per, cfg.latent_dim),
                                    generator=tfs._noise_generator(seed, stream, "cpu"))
            g, row = tfs._grad_epoch_call(plist, blk, seed + stream * (per // tile), cfg,
                                          lw, tile, float(n), None, noise, eps_e)
            total_g = g if total_g is None else [a + b for a, b in zip(total_g, g)]
            total_row = row if total_row is None else total_row + row
        plist, m, v = tft._adam_step(plist, total_g, m, v, torch.tensor(float(e + 1)), 1e-3)
        hist.append(total_row[0, :5].numpy())
    return plist, np.stack(hist)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One world of two gloo ranks: the dp tier's per-rank noise streams
    (prng and hbm), the data-parallel server, and the CLI's train --mesh
    (scan and --fused-scale) and one-shot serve --data-parallel."""
    tmp = tmp_path_factory.mktemp("dp2")
    w = _tiny_corpus(40, 21)
    np.save(tmp / "w.npy", w)
    rows = [{"start_x": -150.0 + i, "start_y": -0.7} for i in range(3)]
    train = ["train", "--scenario", "sce2", "--windows", str(tmp / "w.npy"), "--epochs",
             "3", "--mesh", "--device", "cpu"]
    calls = [
        (worlds.call_with_mesh, (DP, w), dict(epochs=2, tile=8, compute_dtype=None,
                                              noise="prng")),
        (worlds.call_with_mesh, (DP, w), dict(epochs=2, tile=8, compute_dtype=None,
                                              noise="hbm")),
        (worlds.http_program, ({"sce2": str(CKPT)}, 4, 3,
                               [{"requests": rows, "seed": 3},
                                {"requests": rows, "seed": 3, "path": "/generate"},
                                {"requests": rows * 2, "seed": 3}]), {}),
        *((worlds.http_program, ({"sce2": str(CKPT)}, 4, 3,
                                 [{"requests": rows, "seed": 3}] * 2),
           {"fail_call": (rank, 2)}) for rank in (0, 1)),
        (worlds.cli_program, (train + ["--ckpt", str(tmp / "scan")],), {}),
        (worlds.cli_program, (train + ["--ckpt", str(tmp / "dp"), "--fused-scale",
                                       "--tile", "8"],), {}),
        (worlds.cli_program, (["serve", "--data-parallel", "--ckpt", str(CKPT),
                               "--start-x", "-150.0", "--start-y", "-0.7", "--batch", "4",
                               "--steps", "4", "--out", str(tmp / "states.npy"),
                               "--device", "cpu"],), {}),
    ]
    out = spawn_world(worlds.run_all, 2, "gloo", "cpu", args=(calls,), timeout_s=WORLD_S)
    keys = ("prng", "hbm", "http", "fail_0", "fail_1", "cli_scan", "cli_dp", "cli_serve")
    return [dict(zip(keys, r)) for r in out], tmp, w


@pytest.mark.parametrize("noise", ["prng", "hbm"])
def test_scale_dp_streams_are_per_rank(world2, noise):
    res, _, w = world2
    plist, hist = _dp_by_hand(w, noise, 2, 8, 2)
    for r in res:
        params, h = r[noise]
        for a, b in zip(tft._flatten_params(params), plist):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5)
        np.testing.assert_allclose(_hist(h), hist, rtol=1e-4, atol=1e-5)


def test_world_of_one_is_bit_for_bit_mesh_none(windows_sce1):
    """A world of one reduces nothing: the dp tier and the scan trainer give
    the mesh=None bits."""
    from defensive_model_vae_tpu_torch.parallel import create_mesh
    from defensive_model_vae_tpu_torch.train import TrainConfig, train

    mesh = create_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    w = _tiny_corpus(40, 21)
    for noise in ("prng", "hbm"):
        kw = dict(epochs=2, tile=16, compute_dtype="bfloat16", noise=noise)
        p1, h1 = tfs.fused_train_scale_dp(w, device="cpu", **kw)
        pm, hm = tfs.fused_train_scale_dp(w, mesh=mesh, **kw)
        assert all(torch.equal(a, b) for a, b in zip(tft._flatten_params(p1),
                                                      tft._flatten_params(pm)))
        assert all(np.array_equal(h1[k], hm[k]) for k in KEYS)
    _, h1 = train(windows_sce1[:12], train_cfg=TrainConfig(epochs=3), device="cpu")
    _, hm = train(windows_sce1[:12], train_cfg=TrainConfig(epochs=3), mesh=mesh)
    assert all(np.array_equal(h1[k], hm[k]) for k in KEYS)


# ---- the serve program and /generate (test_parallel.py:182-213, test_serving.py:199) -

def test_serve_fn_sharded_over_mesh_matches(world4):
    starts, inits = _serve_inputs()
    fn = make_serve_fn(params_from_numpy(_jax_init(), "cpu"), CVAEConfig(), MPC, 6)
    st, ct = (a.numpy() for a in fn(9, starts, inits))
    for res in world4:
        st_sh, ct_sh = res["serve"]
        assert np.all(np.isfinite(st_sh))
        np.testing.assert_allclose(st_sh, st, atol=1e-5)
        np.testing.assert_allclose(ct_sh, ct, atol=1e-5)


def test_generate_sharded_matches_single(world4):
    starts, _ = _serve_inputs()
    one = build_generate_fn(str(CKPT), device="cpu")(3, starts).numpy()
    for res in world4:
        np.testing.assert_allclose(res["gen"], one, atol=1e-5)


def test_data_parallel_server_answers_as_one_device(world2):
    """Rank 0 serves; each request runs on both ranks' blocks; /serve and
    /generate answer as the one-device server; a request over the batch is
    refused; closing the server stops rank 1."""
    from defensive_model_vae_tpu_torch.serving import build_serve_fn

    res, _, _ = world2
    assert res[1]["http"] is None
    (c1, serve), (c2, gen), (c3, refused) = res[0]["http"]
    assert (c1, c2, c3) == (200, 200, 400) and "exceed" in refused["error"]
    starts = np.zeros((4, 2), np.float32)
    inits = np.zeros((4, 5), np.float32)
    for i in range(4):
        x = -150.0 + min(i, 2) if i < 3 else -150.0
        starts[i] = (x, -0.7)
        inits[i] = (x, -0.7, 1.57, 0.0, 10.0)
    st, ct = build_serve_fn(str(CKPT), 3, 0.1, device="cpu")(3, starts, inits)
    np.testing.assert_allclose(np.asarray(serve["states"], np.float32), st.numpy()[:3],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(serve["controls"], np.float32), ct.numpy()[:3],
                               atol=1e-5)
    g = build_generate_fn(str(CKPT), device="cpu")(3, starts).numpy()[:3]
    np.testing.assert_allclose(np.asarray(gen["trajectories"], np.float32), g, atol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_server_survives_a_failed_request(world2, rank):
    """A request whose block fails on one rank alone is a 500 on rank 0, and
    the group stays in step: the next request is served as before."""
    res, _, _ = world2
    assert res[1][f"fail_{rank}"] is None
    (c1, failed), (c2, served) = res[0][f"fail_{rank}"]
    assert (c1, c2) == (500, 200)
    assert (f"a failure on rank {rank}" if rank == 0 else "data ranks [1] of 2 failed") \
        in failed["error"]
    assert served == res[0]["http"][0][1]


# ---- the CLI over a world of two -----------------------------------------------------

def test_cli_train_mesh_in_a_world_of_two(world2):
    """train --mesh (scan, and --fused-scale's dp tier) over two ranks: rank 0
    alone prints and writes the checkpoint, whose history is the one-device
    run's."""
    from defensive_model_vae_tpu_torch.cli import main
    from defensive_model_vae_tpu_torch.train import load_history

    res, tmp, w = world2
    for key, sub, trainer in (("cli_scan", "scan", "scan"), ("cli_dp", "dp",
                                                              "fused-scale-dp")):
        assert "trained 3 epochs" in res[0][key] and res[1][key] == ""
        recipe = json.loads((tmp / sub / "manifest.json").read_text())["recipe"]
        assert recipe["trainer"] == trainer and recipe["mesh"] == {"data": 2, "model": 1}
    one = tmp / "one"
    main(["train", "--scenario", "sce2", "--windows", str(tmp / "w.npy"), "--epochs", "3",
          "--ckpt", str(one), "--device", "cpu"])
    np.testing.assert_allclose(load_history(str(tmp / "scan"))["total"],
                               load_history(str(one))["total"], rtol=1e-5)


def test_cli_serve_data_parallel_in_a_world_of_two(world2):
    from defensive_model_vae_tpu_torch.serving import build_serve_fn

    res, tmp, _ = world2
    assert "saved (4, 5, 4)" in res[0]["cli_serve"] and res[1]["cli_serve"] == ""
    starts = np.tile([[-150.0, -0.7]], (4, 1)).astype(np.float32)
    inits = np.tile([[-150.0, -0.7, 1.57, 0.0, 10.0]], (4, 1)).astype(np.float32)
    st, _ = build_serve_fn(str(CKPT), 4, 0.02, device="cpu")(0, starts, inits)
    np.testing.assert_allclose(np.load(tmp / "states.npy"), st.numpy(), atol=1e-5)


def test_cli_serve_data_parallel_refuses_a_batch_off_the_world():
    with pytest.raises(RuntimeError, match="multiple of the 2-rank data axis"):
        spawn_world(worlds.cli_program, 2, "gloo", "cpu", timeout_s=WORLD_S,
                    args=(["serve", "--data-parallel", "--ckpt", str(CKPT), "--start-x",
                           "0", "--start-y", "0", "--batch", "3", "--device", "cpu"],))


def test_chip_smoke_parallel_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's parallel phase with the device set to the CPU and its
    sizes cut: the world of one (gloo here) bit for bit mesh=None, the
    spawned world of two held to one device, its rows bit for bit the
    one-device program on the same blocks."""
    import chip_smoke
    from defensive_model_vae_tpu_torch import scenarios
    from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus

    for name, value in (("PAR_DP_N", 4096), ("PAR_DP_EPOCHS", 2), ("PAR_TRAIN_EPOCHS", 2),
                        ("PAR_GLOO_EPOCHS", 2), ("PAR_SERVE_STEPS", 4),
                        ("PAR_SWEEP_FRAMES", 8), ("PAR_WORLD_S", WORLD_S)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "PAR_MPC", {"prediction_horizon": 4,
                                                "control_horizon": 2, "dt": 0.2})
    ws = scale_corpus(chip_smoke.PAR_GLOO_N)
    w4 = np.load(scenarios.get("sce4").fixture_windows)
    info = chip_smoke.parallel_phase(np, torch, torch.device("cpu"), ws, w4, "cpu")
    assert info["nccl"]["backend"] == "gloo" and info["nccl"]["dp_bit_for_bit"]
    assert info["nccl"]["train_bit_for_bit"]
    gloo = info["gloo"]
    assert [r["rank"] for r in gloo["ranks"]] == [0, 1]
    for g in gloo["gaps"].values():
        assert g["block_bit_for_bit"] and g["sweep_frames_off"] == 0
        assert g["dp_params"] <= 1e-5 and g["dp_hist_rel"] <= 1.0
    assert all(r["probe"]["all_gather"] == "ok" for r in gloo["ranks"])
