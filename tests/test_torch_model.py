"""The port's model and loss against the JAX package, on the CPU.

The same inputs (fixture windows; noise and latents from numpy) go through
both packages; the port runs float32 on the CPU.  Tolerances: loss
components rtol 1e-5 (as tests/test_fused.py), decoded trajectories
atol 1e-4 (float32 products of width 128 summed in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights
from defensive_model_vae_tpu.models import cvae_loss as j_cvae_loss
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.models.cvae import decode as j_decode
from defensive_model_vae_tpu.models.cvae import encode as j_encode
from defensive_model_vae_tpu.ops import fused_trainer as jft

from defensive_model_vae_tpu_torch.models import (
    CVAEConfig, LossWeights, cvae_loss, init_params, sample, to_relative)
from defensive_model_vae_tpu_torch.models.cvae import decode, encode
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.train.checkpoint import (
    params_from_numpy, params_to_numpy)

CFG = CVAEConfig()

# one compiled program per JAX function instead of op-by-op dispatch
_j_init = jax.jit(j_init_params, static_argnums=1)
_j_forward_loss = jax.jit(jft._forward_loss, static_argnums=(4, 5),
                          static_argnames=("n_valid",))
_j_step_reference = jax.jit(jft.fused_step_reference)
KEYS = ("total", "recon", "kld", "start", "time")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0):
    jp = _j_init(jax.random.PRNGKey(seed), JCVAEConfig())
    return jp, {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jp.items()}


def test_params_from_numpy_round_trip():
    jp, npp = _jax_params()
    tp = params_from_numpy(npp, "cpu")
    back = params_to_numpy(tp)
    assert set(back) == set(npp)
    for k in npp:
        for n in ("w", "b"):
            assert back[k][n].dtype == np.float32
            assert np.array_equal(back[k][n], npp[k][n])
    # the flat _LAYERS list, biases (1, out), gives the same params
    flat = [np.asarray(a) for a in jft._flatten_params(jp)]
    tp2 = params_from_numpy(flat, "cpu")
    assert all(torch.equal(tp2[k][n], tp[k][n]) for k in tp for n in ("w", "b"))
    with pytest.raises(ValueError):
        params_from_numpy(flat[:-1], "cpu")


def test_init_params_layout_and_bounds():
    p = init_params(torch.Generator().manual_seed(3), CFG, "cpu")
    assert sum(a.numel() for v in p.values() for a in v.values()) == 128942
    assert CFG.n_params() == 128942
    for name, (fi, fo) in CFG.layer_spec().items():
        assert p[name]["w"].shape == (fi, fo) and p[name]["b"].shape == (fo,)
        bound = 1.0 / np.sqrt(fi)
        assert float(p[name]["w"].abs().max()) <= bound
        assert float(p[name]["b"].abs().max()) <= bound
    # the same seed gives the same weights
    q = init_params(torch.Generator().manual_seed(3), CFG, "cpu")
    assert torch.equal(p["dec_0"]["w"], q["dec_0"]["w"])


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator().manual_seed(0), CFG)


@pytest.mark.parametrize("sce", ["sce1", "sce2", "sce4"])
def test_loss_components_match_jax(all_windows, sce):
    """The five loss components of the port — through the flat-layout
    ``_forward_loss`` and through the model stack + ``cvae_loss`` — equal
    the JAX ``_forward_loss`` and ``models.cvae_loss``."""
    w = all_windows[sce]
    jp, npp = _jax_params()
    eps = np.random.default_rng(5).standard_normal((len(w), 8)).astype(np.float32)

    xj, cj = jft.fused_inputs(w)
    _, comps_j = _j_forward_loss(jft._flatten_params(jp), xj, cj,
                                   jnp.asarray(eps), JCVAEConfig(), JLossWeights())
    rel_j, st_j = (jnp.asarray(a) for a in (xj.reshape(len(w), 10, 3), cj))
    mu, lv, hc = j_encode(jp, rel_j, st_j)
    recon = j_decode(jp, mu + jnp.asarray(eps) * jnp.exp(0.5 * lv), hc, JCVAEConfig())
    _, comps_jm = j_cvae_loss(recon, rel_j, mu, lv, JLossWeights())

    tp = params_from_numpy(npp, "cpu")
    xt, ct = tft.fused_inputs(w, "cpu")
    _, comps_t = tft._forward_loss(tft._flatten_params(tp), xt, ct,
                                   torch.tensor(eps), CFG, LossWeights())
    rel_t, st_t = to_relative(torch.tensor(w))
    mu_t, lv_t, hc_t = encode(tp, rel_t, st_t)
    recon_t = decode(tp, mu_t + torch.tensor(eps) * torch.exp(0.5 * lv_t), hc_t, CFG)
    _, comps_tm = cvae_loss(recon_t, rel_t, mu_t, lv_t, LossWeights())

    for i, k in enumerate(KEYS):
        ref = float(comps_j[i])
        assert np.isclose(float(comps_t[i]), ref, rtol=1e-5), k
        assert np.isclose(float(comps_tm[k]), float(comps_jm[k]), rtol=1e-5), k
        assert np.isclose(float(comps_tm[k]), ref, rtol=1e-5), k


def test_masked_loss_matches_padded(all_windows):
    """Masked means over padded junk rows equal the unpadded loss, in the
    port's flat loss and in ``cvae_loss`` (tests/test_fused.py:96)."""
    w = all_windows["sce2"]
    _, npp = _jax_params()
    tp = params_from_numpy(npp, "cpu")
    plist = tft._flatten_params(tp)
    x, c = tft.fused_inputs(w, "cpu")
    eps = torch.tensor(np.random.default_rng(5).standard_normal((len(w), 8)), dtype=torch.float32)
    total, comps = tft._forward_loss(plist, x, c, eps, CFG, LossWeights())
    pad = 7
    xp = torch.cat([x, (x[:1] * 3.3).repeat(pad, 1)])
    cp = torch.cat([c, (c[:1] + 5).repeat(pad, 1)])
    ep = torch.cat([eps, torch.zeros((pad, 8))])
    mask = torch.cat([torch.ones((len(w), 1)), torch.zeros((pad, 1))])
    total_m, comps_m = tft._forward_loss(plist, xp, cp, ep, CFG, LossWeights(), mask)
    assert np.isclose(float(total), float(total_m), rtol=1e-5)
    assert np.allclose(comps.numpy(), comps_m.numpy(), rtol=1e-5)

    recon = torch.randn((len(w), 10, 3), generator=torch.Generator().manual_seed(1))
    rel, _ = to_relative(torch.tensor(w))
    mu, lv = eps, 0.1 * eps
    _, ref = cvae_loss(recon, rel, mu, lv)
    _, got = cvae_loss(torch.cat([recon, recon[:pad] * 7]), torch.cat([rel, rel[:pad]]),
                       torch.cat([mu, mu[:pad] + 3]), torch.cat([lv, lv[:pad]]),
                       mask=mask[:, 0])
    for k in KEYS:
        assert np.isclose(float(got[k]), float(ref[k]), rtol=1e-5), k


@pytest.mark.parametrize("shift_start", [True, False])
def test_sample_with_explicit_z_matches_jax_decode(all_windows, shift_start):
    """``sample`` with the z JAX drew equals JAX decode (+ the start shift)."""
    w = all_windows["sce4"][:12]
    jp, npp = _jax_params(2)
    starts = w[:, 0, 1:3].astype(np.float32)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (len(w), 8)))
    from defensive_model_vae_tpu.models.cvae import encode_condition as j_enc_cond

    rel = j_decode(jp, jnp.asarray(z), j_enc_cond(jp, jnp.asarray(starts)), JCVAEConfig())
    ref = np.asarray(rel.at[:, :, 1:3].add(jnp.asarray(starts)[:, None, :])
                     if shift_start else rel)
    got = sample(params_from_numpy(npp, "cpu"), None, torch.tensor(starts), CFG,
                 z=torch.tensor(z), shift_start=shift_start)
    assert got.shape == (len(w), 10, 3)
    assert np.allclose(got.numpy(), ref, atol=1e-4)
