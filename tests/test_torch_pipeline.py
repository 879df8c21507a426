"""The port's slice end to end on the CPU, its parity with the JAX package,
and the rule that the port imports nothing of JAX, optax, pandas,
matplotlib or the JAX package.

Tolerances: generated trajectories atol 1e-4 (float32 decoder, another
summation order); tracked states atol 1e-3 (as tests/test_torch_mpc.py).
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.ops import fused_train
from defensive_model_vae_tpu_torch.pipeline import (
    _draw_valid_samples, _valid_waypoint_times, default_mpc_cfg, fixture_starts,
    generate_and_track_from_starts)
from defensive_model_vae_tpu_torch.train import load_checkpoint, save_checkpoint

BANNED = ("jax", "jaxlib", "optax", "pandas", "matplotlib", "defensive_model_vae_tpu")
PORT = REPO_ROOT / "defensive_model_vae_tpu_torch"
SCE2_CKPT = REPO_ROOT / "results" / "checkpoints" / "sce2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_traces(traces, dt):
    for tr in traces:
        assert tr.ndim == 2 and tr.shape[1] == 4 and np.all(np.isfinite(tr))
        assert np.abs(np.diff(tr[:, 3])).max() <= 7.0 * dt * (1 + 1e-4)


def test_slice_end_to_end_small_depth(tmp_path, all_windows):
    """fixture windows → K1 (plain, 20 epochs) → checkpoint → sampling →
    batched tracking; then the same device half from the committed sce2
    checkpoint, whose samples are all valid."""
    w = all_windows["sce2"]
    params, hist = fused_train(w, epochs=20, seed=0, device="cpu")
    assert np.all(np.isfinite(hist["total"])) and hist["total"][-1] < hist["total"][0]
    save_checkpoint(str(tmp_path), params, CVAEConfig(), "sce2", hist)
    loaded, cfg, _ = load_checkpoint(str(tmp_path), "cpu")
    starts, inits = fixture_starts(w)
    sce = scenarios.get("sce2")
    traces, idx = generate_and_track_from_starts(loaded, cfg, starts, inits, seed=0,
                                                 mpc_cfg=default_mpc_cfg(sce))
    gen, ok = _draw_valid_samples(loaded, cfg, starts, 0)
    assert np.all(np.isfinite(gen)) and np.array_equal(idx, np.flatnonzero(ok))
    assert len(traces) == len(idx)

    ck, ck_cfg, _ = load_checkpoint(str(SCE2_CKPT), "cpu")
    traces, idx = generate_and_track_from_starts(ck, ck_cfg, starts[:6], inits[:6], seed=0,
                                                 mpc_cfg=default_mpc_cfg(sce))
    assert len(traces) == len(idx) == 6
    _check_traces(traces, sce.dt)
    # each trace starts at its initial state and runs to its path's end
    for tr, b in zip(traces, idx):
        assert np.allclose(tr[0, :2], inits[b, :2], atol=1e-4)


def test_slice_matches_jax_from_committed_checkpoint(all_windows):
    """Same checkpoint, same z: the generated trajectories and their tracked
    states equal the JAX package's generate + track_batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from defensive_model_vae_tpu.control import track_batch as j_track_batch
    from defensive_model_vae_tpu.models.cvae import decode as j_decode
    from defensive_model_vae_tpu.models.cvae import encode_condition as j_enc_cond
    from defensive_model_vae_tpu.pipeline import _valid_waypoint_times as j_valid
    from defensive_model_vae_tpu.pipeline import default_mpc_cfg as j_mpc_cfg
    from defensive_model_vae_tpu.train.checkpoint import load_checkpoint as j_load
    from defensive_model_vae_tpu_torch.control import track_batch
    from defensive_model_vae_tpu_torch.generate import generate_trajectories

    w = all_windows["sce2"][:4]
    starts, inits = fixture_starts(w)
    z = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    jp, jcfg, _ = j_load(str(SCE2_CKPT))
    ref = np.asarray(j_decode(jp, jnp.asarray(z), j_enc_cond(jp, jnp.asarray(starts)), jcfg)
                     .at[:, :, 1:3].add(jnp.asarray(starts)[:, None, :]))
    ck, cfg, _ = load_checkpoint(str(SCE2_CKPT), "cpu")
    gen = generate_trajectories(ck, cfg, starts, 1, z=z).reshape(4, 10, 3)
    assert np.allclose(gen, ref, atol=1e-4)
    assert np.array_equal(_valid_waypoint_times(gen), np.asarray(j_valid(ref)))

    wps = ref[:, :, [1, 2, 0]].astype(float)
    wps[:, 0, 2] = 0.0
    jcfg_mpc = j_mpc_cfg(__import__("defensive_model_vae_tpu").scenarios.get("sce2"))
    _, s_j, _, n_j = j_track_batch(wps, inits, jcfg_mpc)
    _, s_t, _, n_t = track_batch(wps, inits, default_mpc_cfg(scenarios.get("sce2")),
                                 device="cpu")
    assert np.array_equal(n_j, n_t)
    assert np.allclose(s_t, s_j, atol=1e-3)


def test_redraw_fold_replaces_only_invalid_samples(monkeypatch):
    """Invalid samples are re-drawn with seed + 1000·retry and only they
    are replaced (pipeline.py:181)."""
    import defensive_model_vae_tpu_torch.pipeline as pl

    seen = []

    def fake_generate(params, cfg, starts, n_samples, seed, shift_start):
        seen.append(seed)
        g = np.tile(np.arange(10, dtype=np.float32)[None, :, None], (len(starts), 1, 3))
        g[:, :, 1] = seed  # marks which draw a row came from
        if seed == 5:
            g[1, 3, 0] = -1.0  # row 1 invalid on the first draw
        return g[:, None]

    monkeypatch.setattr(pl, "generate_trajectories", fake_generate)
    gen, ok = pl._draw_valid_samples(None, CVAEConfig(), np.zeros((3, 2), np.float32), 5)
    assert seen == [5, 1005] and ok.all()
    assert list(gen[:, 0, 1]) == [5, 1005, 5]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_pandas_or_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO_ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in BANNED]
    assert bad == []


def test_slice_runs_with_banned_modules_blocked(tmp_path):
    """A subprocess in which jax, optax, pandas, matplotlib and the JAX
    package cannot be imported runs the slice at tiny size on the CPU."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            sys.modules[name] = None
        import numpy as np
        from defensive_model_vae_tpu_torch import cli, scenarios
        from defensive_model_vae_tpu_torch.control import MPCConfig
        from defensive_model_vae_tpu_torch.ops import (
            fused_train, fused_train_multi, fused_train_seeds)
        from defensive_model_vae_tpu_torch.pipeline import (
            fixture_starts, generate_and_track_from_starts,
            generate_and_track_multi_from_starts)
        from defensive_model_vae_tpu_torch.train import (
            load_checkpoint, train, train_conditioned, train_multi_scenario, TrainConfig)
        from defensive_model_vae_tpu_torch.ops import cache_decoy, fused_train_scale
        from defensive_model_vae_tpu_torch.scripts import cache_probe
        import chip_smoke
        w = np.load(scenarios.get("sce2").fixture_windows)
        p, h = fused_train(w, epochs=3, device="cpu")
        pa, ha = fused_train(w, epochs=2, backward="auto", device="cpu")
        p2, h2 = train(w, train_cfg=TrainConfig(epochs=2), device="cpu")
        p3, h3 = train(w, train_cfg=TrainConfig(epochs=2, compute_dtype="bfloat16"),
                       device="cpu")
        pc, hc, cc = train_conditioned(w, np.ones((len(w), 1), np.float32),
                                       TrainConfig(epochs=2), device="cpu")
        pms, hms = train_multi_scenario(dict(a=w, b=w[:3]), TrainConfig(epochs=2),
                                        device="cpu")
        pcs, hcs = fused_train_scale(w, epochs=2, tile=16, mixed_style="bf16_chain",
                                     noise="prng", device="cpu")
        assert len(cache_probe.objects()) == 3 and cc.cond_dim == 3
        import torch
        x = torch.ones(cache_decoy.SHAPE)
        assert torch.equal(cache_decoy.decoy(x), x * 3.0)
        pm, hm = fused_train_multi(dict(a=w, b=w[:3]), epochs=2, device="cpu")
        ps, hs = fused_train_seeds(w, [0, 1], epochs=2, device="cpu")
        assert sorted(pm) == ["a", "b"] and sorted(ps) == [0, 1]
        ck, cfg, _ = load_checkpoint({str(SCE2_CKPT)!r}, "cpu")
        s, i = fixture_starts(w[:2])
        tr, idx = generate_and_track_from_starts(
            ck, cfg, s, i, seed=0, mpc_cfg=MPCConfig(prediction_horizon=6, control_horizon=3,
                                             dt=0.1))
        assert len(tr) == 2 and all(np.isfinite(t).all() for t in tr)
        multi = generate_and_track_multi_from_starts(
            ck, cfg, s, i, seeds=[0, 1], mpc_cfg=MPCConfig(prediction_horizon=6,
                                                          control_horizon=3, dt=0.1))
        assert all(len(multi[k][0]) == 2 for k in (0, 1))
        import json, threading, urllib.request
        from defensive_model_vae_tpu_torch import generate, serving
        from defensive_model_vae_tpu_torch.control import device_reference
        server = serving.serve_checkpoint({{"sce2": {str(SCE2_CKPT)!r}}}, batch=2,
                                          num_steps=3, dt=0.1, warm_seed=1, device="cpu")
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        host, port = server.server_address[:2]
        body = json.dumps({{"requests": [{{"start_x": -150.0, "start_y": -0.7}}],
                           "seed": 3}}).encode()
        with urllib.request.urlopen(f"http://{{host}}:{{port}}/serve", data=body,
                                    timeout=120) as r:
            got = json.loads(r.read())
        server.shutdown()
        server.server_close()
        assert np.asarray(got["states"]).shape == (1, 4, 4)
        assert np.isfinite(np.asarray(got["states"])).all()
        banned = [m for m in sys.modules if m.split(".")[0] in {BANNED!r}
                  and sys.modules[m] is not None]
        assert not banned, banned
        print("SLICE_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SLICE_OK" in out.stdout


def test_cli_train_and_generate(tmp_path, capsys):
    import json

    from defensive_model_vae_tpu_torch.cli import main

    ck = tmp_path / "ck"
    main(["train", "--scenario", "sce2", "--windows",
          str(REPO_ROOT / "fixtures" / "trajectory_sce2_cond.npy"), "--ckpt", str(ck),
          "--epochs", "4", "--fused", "--device", "cpu"])
    manifest = json.loads((ck / "manifest.json").read_text())
    assert manifest["recipe"]["trainer"] == "fused" and manifest["recipe"]["epochs"] == 4
    assert manifest["scenario"] == "sce2"
    out = tmp_path / "gen.npy"
    main(["generate", "--ckpt", str(ck), "--start-x", "-155", "--start-y", "-5",
          "-n", "3", "--out", str(out), "--device", "cpu"])
    g = np.load(out)
    assert g.shape == (1, 3, 10, 3) and np.all(np.isfinite(g))
    assert "checkpoint at" in capsys.readouterr().out


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """Without a GPU — or run from a directory holding only the script — the
    chip check exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO_ROOT, REPO_ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO_ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
