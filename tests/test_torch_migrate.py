"""Checkpoint migration on the CPU: optimizer state, ``.pth`` import and
export, and the refused Orbax backend, each against the JAX package.

Every comparison here is bit for bit: the files hold float32 arrays that
both packages read and write without arithmetic.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import REPO_ROOT
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import ConvCVAEConfig as JConvCVAEConfig
from defensive_model_vae_tpu.models import init_conv_params as j_init_conv_params
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
from defensive_model_vae_tpu.train import checkpoint as jck
from defensive_model_vae_tpu.train import torch_import as jti
from defensive_model_vae_tpu.train.train import train as j_train

from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.train import (
    TrainConfig, load_checkpoint, load_history, load_opt_state, params_to_numpy,
    save_checkpoint, save_opt_state, train)
from defensive_model_vae_tpu_torch.train.torch_import import (
    _NAME_MAP, export_to_pth, import_to_checkpoint, load_torch_checkpoint)

CKPTS = REPO_ROOT / "results" / "checkpoints"
SCENARIOS = ("sce1", "sce2", "sce3", "sce4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_trees(port, ref):
    got = params_to_numpy(port)
    assert set(got) == set(ref)
    for k in got:
        for n in ("w", "b"):
            a, b = got[k][n], np.asarray(ref[k][n])
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, n)


# ---- optimizer state ----------------------------------------------------------

def test_opt_state_saved_by_jax_loads_in_the_port(tmp_path, all_windows):
    w = all_windows["sce2"]
    jp, _, jstate = j_train(w, train_cfg=JTrainConfig(epochs=3), return_state=True)
    jck.save_checkpoint(str(tmp_path), jp, JCVAEConfig(), "sce2")
    jck.save_opt_state(str(tmp_path), jstate)
    params, _, _ = load_checkpoint(str(tmp_path), "cpu")
    state = load_opt_state(str(tmp_path), params)
    adam = jstate[0]
    assert state["count"] == int(adam.count) == 3
    _equal_trees(state["m"], jax.device_get(adam.mu))
    _equal_trees(state["v"], jax.device_get(adam.nu))
    # the port resumes from it
    p2, h2 = train(w, train_cfg=TrainConfig(epochs=2), init_state=(params, state),
                   start_epoch=3, device="cpu")
    assert np.all(np.isfinite(h2["total"]))


def test_opt_state_saved_by_the_port_loads_in_jax(tmp_path, all_windows):
    import optax

    w = all_windows["sce2"]
    params, hist, state = train(w, train_cfg=TrainConfig(epochs=4), return_state=True,
                                device="cpu")
    save_checkpoint(str(tmp_path), params, CVAEConfig(), "sce2", hist)
    save_opt_state(str(tmp_path), state)
    jp, _, _ = jck.load_checkpoint(str(tmp_path))
    jstate = jck.load_opt_state(str(tmp_path), jp, optax.adam(1e-3))
    assert int(jstate[0].count) == 4 and jstate[0].count.dtype == np.int32
    _equal_trees(state["m"], jax.device_get(jstate[0].mu))
    _equal_trees(state["v"], jax.device_get(jstate[0].nu))
    # and JAX resumes from it
    jp2, jh2 = j_train(w, train_cfg=JTrainConfig(epochs=1), init_state=(jp, jstate),
                       start_epoch=4)
    assert np.all(np.isfinite(np.asarray(jh2["total"])))


def test_resume_through_files_equals_one_run(tmp_path, all_windows):
    """10 epochs, checkpoint + opt_state.npz, 10 more from the loaded files
    at start_epoch 10: bit for bit one 20-epoch run."""
    w = all_windows["sce4"]
    p1, h1, s1 = train(w, train_cfg=TrainConfig(epochs=10, seed=5), return_state=True,
                       device="cpu")
    save_checkpoint(str(tmp_path), p1, CVAEConfig(), "sce4", h1)
    save_opt_state(str(tmp_path), s1)
    pl, _, _ = load_checkpoint(str(tmp_path), "cpu")
    p2, h2 = train(w, train_cfg=TrainConfig(epochs=10, seed=5),
                   init_state=(pl, load_opt_state(str(tmp_path), pl)), start_epoch=10,
                   device="cpu")
    pf, hf = train(w, train_cfg=TrainConfig(epochs=20, seed=5), device="cpu")
    for k in hf:
        assert np.array_equal(np.concatenate([h1[k], h2[k]]), hf[k]), k
    assert all(torch.equal(p2[k][n], pf[k][n]) for k in pf for n in ("w", "b"))
    assert np.array_equal(load_history(str(tmp_path))["total"], h1["total"])


def test_opt_state_absent_or_mismatched(tmp_path, all_windows):
    params, hist, state = train(all_windows["sce2"], train_cfg=TrainConfig(epochs=1),
                                return_state=True, device="cpu")
    save_checkpoint(str(tmp_path), params, CVAEConfig(), "sce2")
    assert load_opt_state(str(tmp_path), params) is None
    assert load_history(str(tmp_path)) is None
    save_opt_state(str(tmp_path), state)
    other = {k: dict(v) for k, v in params.items()}
    other["enc_0"] = {"w": torch.zeros(3, 3), "b": params["enc_0"]["b"]}
    with pytest.raises(ValueError, match="shape"):
        load_opt_state(str(tmp_path), other)
    extra = dict(params, extra_layer={"w": torch.zeros(1), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="lacks"):
        load_opt_state(str(tmp_path), extra)


# ---- .pth import and export ---------------------------------------------------

@pytest.mark.parametrize("sce", SCENARIOS)
def test_pth_interchange_with_jax_for_committed_checkpoints(tmp_path, sce):
    """Each committed checkpoint: the port's export loads in JAX's
    load_torch_checkpoint, JAX's export in the port's, bit for bit."""
    d = str(CKPTS / sce)
    ref, _, _ = jck.load_checkpoint(d)
    port_pth, jax_pth = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    assert export_to_pth(d, port_pth) == port_pth
    jti.export_to_pth(d, jax_pth)
    jp, jcfg = jti.load_torch_checkpoint(port_pth)
    for k in ref:
        for n in ("w", "b"):
            assert np.array_equal(np.asarray(jp[k][n]), np.asarray(ref[k][n]))
    params, cfg = load_torch_checkpoint(jax_pth, device="cpu")
    _equal_trees(params, ref)
    assert cfg == CVAEConfig(**{f: getattr(jcfg, f) for f in
                                ("seq_len", "dim", "latent_dim", "hidden_dim", "cond_dim")})
    # both files are the same state_dict, tensor for tensor
    a, b = torch.load(port_pth, weights_only=True), torch.load(jax_pth, weights_only=True)
    assert set(a) == set(b) == {f"{t}.{s}" for t in _NAME_MAP for s in ("weight", "bias")}
    assert all(a[k].dtype == torch.float32 and torch.equal(a[k], b[k]) for k in a)
    assert a["condition_encoder.0.weight"].shape == (128, 2)


def _reference_state(cfg, seed):
    params = j_init_params(jax.random.PRNGKey(seed), cfg)
    return {f"{t}.{s}": torch.tensor(np.asarray(params[o][k]).T.copy() if k == "w"
                                     else np.asarray(params[o][k]))
            for t, o in _NAME_MAP.items() for s, k in (("weight", "w"), ("bias", "b"))}


def test_import_parses_basename_not_directory(tmp_path):
    """JAX tests/test_model.py:252: offset_mode and the scenario come from
    the file name, never the directories; an unregistered 'sce10' gives
    None; the ambiguous width defaults to dim 3 unless dim is given."""
    state = _reference_state(JCVAEConfig(), 0)
    d = tmp_path / "offset_experiments" / "sce2_backup"
    d.mkdir(parents=True)
    pth = d / "vae_sce1_ld8_epoch3000.pth"
    torch.save(state, pth)
    import_to_checkpoint(str(pth), str(tmp_path / "ck"), device="cpu")
    mf = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert mf["offset_mode"] is False and mf["scenario"] == "sce1"
    assert mf["imported_from"] == str(pth)
    pth10 = d / "vae_sce10_ld8.pth"
    torch.save(state, pth10)
    import_to_checkpoint(str(pth10), str(tmp_path / "ck10"), device="cpu")
    assert json.loads((tmp_path / "ck10" / "manifest.json").read_text())["scenario"] is None
    pth_off = tmp_path / "vae_offset_sce4_cond_ld8_epoch3000.pth"
    torch.save(state, pth_off)
    import_to_checkpoint(str(pth_off), str(tmp_path / "ck_off"), device="cpu")
    mf = json.loads((tmp_path / "ck_off" / "manifest.json").read_text())
    assert mf["offset_mode"] is True and mf["scenario"] == "sce4"
    # the same manifests as JAX's importer writes
    jti.import_to_checkpoint(str(pth_off), str(tmp_path / "jck_off"))
    jmf = json.loads((tmp_path / "jck_off" / "manifest.json").read_text())
    assert {k: jmf[k] for k in ("scenario", "offset_mode", "model_config")} == \
        {k: mf[k] for k in ("scenario", "offset_mode", "model_config")}

    pth2 = tmp_path / "vae_sce1_amb.pth"
    torch.save(_reference_state(JCVAEConfig(seq_len=9, dim=2), 1), pth2)
    _, c_default = load_torch_checkpoint(str(pth2), device="cpu")
    assert (c_default.seq_len, c_default.dim) == (6, 3)
    _, c_dim2 = load_torch_checkpoint(str(pth2), dim=2, device="cpu")
    assert (c_dim2.seq_len, c_dim2.dim) == (9, 2)
    with pytest.raises(ValueError, match="not divisible"):
        load_torch_checkpoint(str(pth2), dim=4, device="cpu")


def test_conv_checkpoint_refuses_to_export(tmp_path):
    """JAX tests/test_model.py:340-345: a Conv1D checkpoint has no reference
    class; the export fails with JAX's ValueError."""
    ccfg = JConvCVAEConfig(seq_len=20, dim=2)
    d = jck.save_checkpoint(str(tmp_path / "conv"), j_init_conv_params(
        jax.random.PRNGKey(0), ccfg), ccfg, None)
    with pytest.raises(ValueError, match="not a reference-family"):
        export_to_pth(d, str(tmp_path / "conv.pth"))
    assert not (tmp_path / "conv.pth").exists()


def test_import_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pth = tmp_path / "vae_sce1.pth"
    torch.save(_reference_state(JCVAEConfig(), 2), pth)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_torch_checkpoint(str(pth))


def test_orbax_checkpoint_is_refused_with_the_conversion(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    cfg = JCVAEConfig()
    d = str(tmp_path / "orbax_ck")
    jck.save_checkpoint(d, j_init_params(jax.random.PRNGKey(0), cfg), cfg, "sce2",
                        backend="orbax")
    with pytest.raises(ValueError, match="backend='npz'"):
        load_checkpoint(d, "cpu")
    # the conversion the message names: load in JAX, save again as npz
    jp, jcfg, _ = jck.load_checkpoint(d)
    jck.save_checkpoint(d, jp, jcfg, "sce2", backend="npz")
    params, cfg2, manifest = load_checkpoint(d, "cpu")
    assert manifest["backend"] == "npz" and cfg2.hidden_dim == cfg.hidden_dim
    _equal_trees(params, jax.device_get(jp))
