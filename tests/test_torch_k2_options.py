"""K2's two last options — ``use_mask`` and ``_metrics`` — against the JAX
package's K2 in interpret mode.

JAX's ``_fused_multi_call`` (ops/fused_trainer.py:528) takes S padded
corpora (S, B, …) with a row mask; ``use_mask=False`` runs the unmasked
epoch body, in which padded rows count as rows, and ``_metrics="static"``
writes every epoch's metrics to row 0.  The port's K2 takes ragged rows:
``padded_rows`` turns the padded form into them (the blocks whole without
the mask, each run's marked rows with it), and ``_metrics`` is a runtime
argument of the kernel.  On the CPU the port runs K2's plain version; the
kernel is held against it on the card (chip_smoke.py, ``drivers``).

Tolerances: params atol 1e-5 and metrics rtol 1e-5, as
tests/test_torch_multi.py::test_k2_plain_matches_jax_k2_interpret (float32
summed in another order, compounded over 3 epochs).  The static store
against the full one within the port: bit for bit (the same arithmetic,
only the row written differs).
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
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

CFG, LW = CVAEConfig(), LossWeights()
B, EPOCHS, SEED = 6, 3, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def padded(all_windows):
    """Two corpora padded to B = 6 as ``fused_train_multi`` pads them: sce1's
    first 6 windows, and sce2's first 4 with two copies of its first row.
    ε (2, 6, 8) is non-zero on the padded rows too, so the unmasked body's
    row-to-noise mapping shows; JAX's init ``PRNGKey(SEED + i)``."""
    blocks = [all_windows["sce1"][:B],
              np.concatenate([all_windows["sce2"][:4], np.repeat(all_windows["sce2"][:1], 2, 0)])]
    ins = [tft.fused_inputs(w, "cpu") for w in blocks]
    x = torch.stack([a for a, _ in ins])
    cond = torch.stack([c for _, c in ins])
    mask = torch.ones((2, B, 1))
    mask[1, 4:] = 0.0
    eps = torch.as_tensor(np.random.default_rng(5).standard_normal((2, B, 8)).astype(np.float32))
    j_init = [jft._flatten_params(j_init_params(jax.random.PRNGKey(SEED + i), JCVAEConfig()))
              for i in range(2)]
    stacked_np = [np.stack([np.asarray(p[j]) for p in j_init]) for j in range(24)]
    stacked = tft.stack_flat_params(params_from_numpy(stacked_np, "cpu", stacked=True))
    return {"x": x, "cond": cond, "mask": mask, "eps": eps, "stacked": stacked,
            "j_plists": tuple(jnp.asarray(a) for a in stacked_np)}


def _jax_k2(p, use_mask, metrics):
    out, m = jft._fused_multi_call(
        p["j_plists"], jnp.asarray(p["x"].numpy()), jnp.asarray(p["cond"].numpy()),
        jnp.asarray(p["mask"].numpy()), jnp.array([[SEED, SEED + 1]], jnp.int32),
        JCVAEConfig(), JLossWeights(), EPOCHS, 1e-3, eps=jnp.asarray(p["eps"].numpy()),
        interpret=True, use_mask=use_mask, _metrics=metrics)
    return [np.asarray(a) for a in out], np.asarray(m)


def _port_k2(p, use_mask, metrics):
    return tft._fused_multi_call_padded(p["stacked"], p["x"], p["cond"], p["mask"],
                                        [SEED, SEED + 1], CFG, LW, EPOCHS, 1e-3, p["eps"],
                                        use_mask=use_mask, _metrics=metrics)


def _assert_params_close(j_out, port_out, atol=1e-5):
    for a, b in zip(j_out, port_out):
        assert np.allclose(b.numpy(), a.reshape(b.shape), atol=atol)


@pytest.mark.parametrize("use_mask", [False, True])
def test_k2_padded_form_matches_jax_interpret(padded, use_mask):
    """The port's plain K2 on JAX's padded form against JAX's K2 in
    interpret mode, with the mask and without it (padded rows counted)."""
    jo, jm = _jax_k2(padded, use_mask, "full")
    before = (tft._fused_multi_call.launches, tft._fused_multi_call.unmasked_launches)
    out, metrics = _port_k2(padded, use_mask, "full")
    assert (tft._fused_multi_call.launches, tft._fused_multi_call.unmasked_launches) == before
    assert metrics.shape == (2, EPOCHS, 8)
    _assert_params_close(jo, out)
    assert np.allclose(metrics[..., :5].numpy(), jm[..., :5], rtol=1e-5)


@pytest.mark.parametrize("use_mask", [False, True])
def test_k2_static_metrics_matches_jax_and_full(padded, use_mask):
    """``_metrics="static"``: the params bit for bit those of ``"full"`` and
    within tolerance of JAX's static run; row 0 equal to ``"full"``'s last
    row and to JAX's static row 0; the other rows zeros."""
    jo, jm = _jax_k2(padded, use_mask, "static")
    full_out, full_m = _port_k2(padded, use_mask, "full")
    out, m = _port_k2(padded, use_mask, "static")
    assert all(torch.equal(a, b) for a, b in zip(out, full_out))
    assert torch.equal(m[:, 0], full_m[:, -1])
    assert torch.all(m[:, 1:] == 0)
    _assert_params_close(jo, out)
    assert np.allclose(m[:, 0, :5].numpy(), jm[:, 0, :5], rtol=1e-5)


def test_unmasked_counts_padded_rows(padded):
    """Without the mask the padded run trains on all six rows; with it on
    its four: the two differ for run 1 and agree for run 0, which has no
    padding."""
    m_out, m_hist = _port_k2(padded, True, "full")
    u_out, u_hist = _port_k2(padded, False, "full")
    assert torch.equal(m_hist[0], u_hist[0])
    assert not torch.allclose(m_hist[1], u_hist[1], rtol=1e-3)


def test_padded_rows_maps_blocks_and_masks(padded):
    x, c, off, e = tft.padded_rows(padded["x"], padded["cond"], padded["mask"],
                                   padded["eps"], use_mask=False)
    assert off == [0, 6, 12] and torch.equal(e[6:], padded["eps"][1])
    x, c, off, e = tft.padded_rows(padded["x"], padded["cond"], padded["mask"],
                                   padded["eps"], use_mask=True)
    assert off == [0, 6, 10] and torch.equal(x[6:], padded["x"][1, :4])
    assert torch.equal(e[6:], padded["eps"][1, :4])


@pytest.mark.parametrize("rows", [[1, 0, 1, 1, 1, 1], [0] * 6])
def test_padded_rows_refuses_masks_that_are_not_a_prefix(padded, rows):
    mask = padded["mask"].clone()
    mask[1, :, 0] = torch.tensor(rows, dtype=torch.float32)
    with pytest.raises(ValueError, match="mask"):
        tft.padded_rows(padded["x"], padded["cond"], mask, padded["eps"], use_mask=True)


def test_unknown_metrics_store_is_refused(padded):
    with pytest.raises(ValueError, match="_metrics"):
        _port_k2(padded, False, "dynamic")
