"""Kernel K1's plain version and its wrapper, against the JAX package.

On the CPU the K1 wrapper runs its plain version (per epoch: ε, the ported
manual backward, Adam); the CUDA kernel itself is held against that plain
version on the card (tests/test_torch_k1_card.py and chip_smoke.py).  Tolerances:

- manual gradients vs ``jax.grad`` of ``_forward_loss``: components
  atol 1e-6·scale, gradients 2e-6 of each array's max (as
  tests/test_fused_scale.py:352, float32 summed in another order);
- one epoch vs ``fused_step_reference``: metrics rtol 1e-5; params atol
  1e-6 wherever |g| ≥ 1e-6 (as tests/test_fused.py:59).  Where |g| is below
  that, Adam's first step lr·g/(|g|+1e-8) turns the gradient's summation-
  order noise into a step difference, bounded by one step: atol lr = 1e-3.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.ops import fused_trainer as jft

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.ops.manual_grad import manual_value_and_grad
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

CFG = CVAEConfig()

# one compiled program per JAX function instead of op-by-op dispatch
_j_init = jax.jit(j_init_params, static_argnums=1)
_j_forward_loss = jax.jit(jft._forward_loss, static_argnums=(4, 5),
                          static_argnames=("n_valid",))
_j_step_reference = jax.jit(jft.fused_step_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(w, seed=0, eps_seed=12):
    jp = _j_init(jax.random.PRNGKey(seed), JCVAEConfig())
    npp = {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jp.items()}
    eps = np.random.default_rng(eps_seed).standard_normal((len(w), 8)).astype(np.float32)
    return jp, params_from_numpy(npp, "cpu"), eps


@pytest.mark.parametrize("mode", ["full", "mask_nvalid", "mask"])
def test_manual_grads_match_jax_autodiff(all_windows, mode):
    w = all_windows["sce3"][:24]
    jp, tp, eps = _setup(w)
    mask_np = np.concatenate([np.ones((20, 1)), np.zeros((4, 1))]).astype(np.float32)
    mask, nv = {"full": (None, None), "mask_nvalid": (mask_np, 24.0),
                "mask": (mask_np, None)}[mode]
    xj, cj = jft.fused_inputs(w)
    (_, comps), grads = jax.value_and_grad(
        lambda pl_: _j_forward_loss(pl_, xj, cj, jnp.asarray(eps), JCVAEConfig(),
                                      JLossWeights(),
                                      None if mask is None else jnp.asarray(mask),
                                      n_valid=nv),
        has_aux=True)(jft._flatten_params(jp))
    xt, ct = tft.fused_inputs(w, "cpu")
    comps_t, grads_t = manual_value_and_grad(
        tft._flatten_params(tp), xt, ct, torch.tensor(eps), CFG, LossWeights(),
        None if mask is None else torch.tensor(mask), n_valid=nv)
    comps = np.asarray(comps)
    assert np.allclose(comps, comps_t.numpy(), rtol=1e-6, atol=1e-6 * np.abs(comps).max())
    assert len(grads_t) == len(grads) == 24
    for a, b in zip(grads, grads_t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.allclose(a, b, atol=2e-6 * max(np.abs(a).max(), 1e-3))


def test_plain_k1_one_epoch_matches_fused_step_reference(all_windows):
    w = all_windows["sce2"]
    jp, tp, eps = _setup(w, eps_seed=9)
    ref_p, ref_c = _j_step_reference(jp, w, jnp.asarray(eps))
    xj, cj = jft.fused_inputs(w)
    _, grads = jax.value_and_grad(
        lambda pl_: _j_forward_loss(pl_, xj, cj, jnp.asarray(eps), JCVAEConfig(),
                                      JLossWeights()), has_aux=True)(jft._flatten_params(jp))
    xt, ct = tft.fused_inputs(w, "cpu")
    out, metrics = tft.fused_call(tft._flatten_params(tp), xt, ct, 0, CFG,
                                  LossWeights(), 1, 1e-3, torch.tensor(eps))
    assert metrics.shape == (1, 8)
    assert np.allclose(metrics[0, :5].numpy(), np.asarray(ref_c), rtol=1e-5)
    assert np.all(metrics[0, 5:].numpy() == 0)
    for a, b, g in zip(jft._flatten_params(ref_p), out, grads):
        a, b, g = np.asarray(a), b.numpy(), np.abs(np.asarray(g))
        big = g >= 1e-6
        assert np.allclose(a[big], b[big], atol=1e-6)
        assert np.allclose(a, b, atol=1e-3)


def test_port_fused_step_reference_matches_jax(all_windows):
    """The port's own oracle (autograd of its ``_forward_loss`` + one Adam
    step) equals the JAX ``fused_step_reference``, with the tolerances
    above, and equals one epoch of K1's plain version."""
    w = all_windows["sce2"]
    jp, tp, eps = _setup(w, eps_seed=9)
    ref_p, ref_c = _j_step_reference(jp, w, jnp.asarray(eps))
    got_p, got_c = tft.fused_step_reference(tp, w, eps)
    assert np.allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-5)
    for a, b in zip(jft._flatten_params(ref_p), tft._flatten_params(got_p)):
        assert np.allclose(np.asarray(a), b.numpy(), atol=1e-3)
    xt, ct = tft.fused_inputs(w, "cpu")
    out, metrics = tft.fused_call(tft._flatten_params(tp), xt, ct, 0, CFG,
                                  LossWeights(), 1, 1e-3, torch.tensor(eps))
    assert np.allclose(metrics[0, :5].numpy(), got_c.numpy(), rtol=1e-5)
    for a, b in zip(tft._flatten_params(got_p), out):
        assert np.allclose(a.numpy(), b.numpy(), atol=1e-3)


def test_plain_k1_explicit_eps_descends(all_windows):
    """30 epochs with an explicit ε held constant descend and stay finite
    (tests/test_fused.py:77)."""
    w = all_windows["sce2"]
    _, tp, eps = _setup(w, eps_seed=4)
    xt, ct = tft.fused_inputs(w, "cpu")
    out, metrics = tft.fused_call(tft._flatten_params(tp), xt, ct, 0, CFG,
                                  LossWeights(), 30, 1e-3, torch.tensor(eps))
    m = metrics[:, 0].numpy()
    assert metrics.shape == (30, 8)
    assert np.all(np.isfinite(m)) and m[-1] < m[0]
    assert set(tft._unflatten_params(out)) == set(tp)


def test_fused_train_philox_descends_and_is_deterministic(all_windows):
    w = all_windows["sce2"]
    p1, h1 = tft.fused_train(w, epochs=25, seed=3, device="cpu")
    p2, h2 = tft.fused_train(w, epochs=25, seed=3, device="cpu")
    assert set(h1) == set(tft.FUSED_METRIC_KEYS)
    assert h1["total"][-1] < h1["total"][0]
    assert np.array_equal(h1["total"], h2["total"])
    assert torch.equal(p1["dec_3"]["w"], p2["dec_3"]["w"])
    _, h3 = tft.fused_train(w, epochs=25, seed=4, device="cpu")
    assert not np.array_equal(h1["total"], h3["total"])


def test_k1_wrapper_never_falls_back():
    """A CUDA request without CUDA raises; a tensor on another device is
    refused; the CPU path is the plain version and counts no launch."""
    w = np.load(__import__("conftest").FIXTURES / "trajectory_sce2_cond.npy")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tft.fused_train(w, epochs=1)
    x = torch.zeros((4, 30), device="meta")
    with pytest.raises(ValueError, match="CUDA or"):
        tft.fused_call([], x, x, 0, CFG, LossWeights(), 1, 1e-3)
    before = tft.fused_call.launches
    tft.fused_train(w, epochs=2, device="cpu")
    assert tft.fused_call.launches == before


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    out0 = [int(a) for a in tft.philox4x32((z, z, z, z), (0, 0))]
    out1 = [int(a) for a in tft.philox4x32((f, f, f, f), (0xFFFFFFFF, 0xFFFFFFFF))]
    assert out0 == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert out1 == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_normal_is_standard_normal_and_keyed():
    n = tft.philox_normal(11, 0, 4000, 8)
    assert n.shape == (4000, 8) and n.dtype == torch.float32
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1.0) < 0.02
    assert torch.equal(n, tft.philox_normal(11, 0, 4000, 8))
    assert not torch.equal(n[:5], tft.philox_normal(11, 1, 5, 8))
    assert not torch.equal(n[:5], tft.philox_normal(12, 0, 5, 8))
    # rows are counters: a prefix of rows is the same draw
    assert torch.equal(n[:5], tft.philox_normal(11, 0, 5, 8))


def test_kernel_param_packing_round_trip():
    from defensive_model_vae_tpu_torch.models import init_params

    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, "cpu"))
    flat = tft.pack_kernel_params(plist)
    assert flat.shape == (128942,) and flat.is_contiguous()
    back = tft.unpack_kernel_params(flat, plist)
    assert all(torch.equal(a, b) for a, b in zip(back, plist))
    # the merged head sits between enc_3 and dec_0: [fc_mu | fc_logvar]
    spec = CFG.layer_spec()
    off = sum(fi * fo + fo for n, (fi, fo) in spec.items()
              if n in ("cond_0", "cond_1", "enc_0", "enc_1", "enc_2", "enc_3"))
    head = flat[off:off + 256 * 16].reshape(256, 16)
    assert torch.equal(head[:, :8], plist[12]) and torch.equal(head[:, 8:], plist[14])
