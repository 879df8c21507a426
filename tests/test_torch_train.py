"""The port's scan-tier trainer and checkpoints, on the CPU.

Training noise differs from JAX's by construction (torch generators are
not jax.random), so the trainer is held to descent and to exact chunked
resume; checkpoints are held to exact round trips through both packages.
"""

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.train import (
    TrainConfig, load_checkpoint, params_to_numpy, require_cvae_config,
    save_checkpoint, train)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_descends(all_windows):
    params, hist = train(all_windows["sce2"], train_cfg=TrainConfig(epochs=30, seed=1),
                         device="cpu")
    assert set(hist) == {"total", "recon", "kld", "start", "time"}
    assert all(len(v) == 30 and np.all(np.isfinite(v)) for v in hist.values())
    assert hist["total"][-1] < hist["total"][0]
    assert params["dec_3"]["w"].shape == (128, 30)


def test_chunked_resume_equals_one_run(all_windows):
    """10 + 10 epochs resumed at start_epoch=10 reproduce one 20-epoch run
    exactly: the noise follows the global epoch and Adam's count carries."""
    w = all_windows["sce2"]
    p_full, h_full = train(w, train_cfg=TrainConfig(epochs=20, seed=2), device="cpu")
    p1, h1, st = train(w, train_cfg=TrainConfig(epochs=10, seed=2), return_state=True,
                       device="cpu")
    assert st["count"] == 10
    p2, h2 = train(w, train_cfg=TrainConfig(epochs=10, seed=2), init_state=(p1, st),
                   start_epoch=10, device="cpu")
    for k in h_full:
        assert np.array_equal(np.concatenate([h1[k], h2[k]]), h_full[k]), k
    for layer in p_full:
        for n in ("w", "b"):
            assert torch.equal(p2[layer][n], p_full[layer][n])


def test_checkpoint_round_trip_and_jax_interchange(tmp_path, all_windows):
    pytest.importorskip("jax")
    from defensive_model_vae_tpu.train.checkpoint import load_checkpoint as j_load

    params, hist = train(all_windows["sce2"], train_cfg=TrainConfig(epochs=3),
                         device="cpu")
    cfg = CVAEConfig()
    save_checkpoint(str(tmp_path), params, cfg, "sce2", hist,
                    extra_manifest={"recipe": {"trainer": "scan"}})
    loaded, cfg2, manifest = load_checkpoint(str(tmp_path), "cpu")
    assert cfg2 == cfg and manifest["scenario"] == "sce2"
    assert manifest["recipe"] == {"trainer": "scan"}
    assert all(torch.equal(loaded[k][n], params[k][n]) for k in params for n in ("w", "b"))
    # the JAX package reads what the port wrote, value for value
    jp, jcfg, _ = j_load(str(tmp_path))
    ref = params_to_numpy(params)
    assert jcfg.hidden_dim == cfg.hidden_dim
    assert all(np.array_equal(np.asarray(jp[k][n]), ref[k][n]) for k in ref for n in ("w", "b"))
    # re-saving without history drops the stale loss curves
    save_checkpoint(str(tmp_path), params, cfg)
    assert not (tmp_path / "history.npz").exists()


@pytest.mark.parametrize("sce", ["sce1", "sce2", "sce3", "sce4"])
def test_committed_checkpoints_load(sce):
    """results/checkpoints/sce*/ load unchanged and agree with the JAX
    package's loader."""
    pytest.importorskip("jax")
    from defensive_model_vae_tpu.train.checkpoint import load_checkpoint as j_load

    d = str(REPO_ROOT / "results" / "checkpoints" / sce)
    params, cfg, manifest = load_checkpoint(d, "cpu")
    require_cvae_config(cfg, "test")
    assert manifest["scenario"] == sce
    jp, _, _ = j_load(d)
    got = params_to_numpy(params)
    assert set(got) == set(jp)
    assert all(np.array_equal(got[k][n], np.asarray(jp[k][n])) for k in got for n in ("w", "b"))


def test_require_cvae_config_rejects_other_configs():
    with pytest.raises(TypeError, match="MLP CVAE"):
        require_cvae_config({"channels": [16, 32]}, "generation")
