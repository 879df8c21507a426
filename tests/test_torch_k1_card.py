"""Kernel K1 on the card, against its plain version.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_k1_card.py -q

Tolerances as in chip_smoke.py: one epoch with explicit ε, params atol
1e-4 and metrics rtol 1e-5 (summation order only).  A run is one
thread-block cluster; every cluster size computes every sum in the same
order, so the sizes are held to each other bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"
CFG = CVAEConfig()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, sce="sce4"):
    w = np.load(FIXTURES / f"trajectory_{sce}_cond.npy")
    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    x, c = tft.fused_inputs(w, dev)
    eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (len(w), 8)).astype(np.float32)).to(dev)
    return plist, x, c, eps


@pytest.mark.gpu
@pytest.mark.parametrize("sce", ["sce2", "sce4"])
def test_k1_one_epoch_matches_plain(sce):
    dev = _cuda()
    plist, x, c, eps = _inputs(dev, sce)
    before = tft.fused_call.launches
    pk, mk = tft.fused_call(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, eps)
    assert tft.fused_call.launches == before + 1
    pp, mp = tft._fused_call_plain(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, eps)
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-4
    assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_k1_philox_noise_matches_plain():
    """Without ε the kernel draws the same Philox noise as the plain
    version: one epoch agrees as closely as with explicit ε."""
    dev = _cuda()
    plist, x, c, _ = _inputs(dev)
    pk, mk = tft.fused_call(plist, x, c, 5, CFG, LossWeights(), 1, 1e-3)
    pp, mp = tft._fused_call_plain(plist, x, c, 5, CFG, LossWeights(), 1, 1e-3, None)
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-4
    assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_k1_wrapper_refuses_bad_inputs():
    dev = _cuda()
    plist, x, c, eps = _inputs(dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        tft.fused_call(plist, x.double(), c, 0, CFG, LossWeights(), 1, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        tft.fused_call(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, eps[:, :4].contiguous())
    with pytest.raises(ValueError, match="compiled for"):
        tft.fused_call(plist, x, c, 0, CVAEConfig(hidden_dim=64), LossWeights(), 1, 1e-3)


def _same(a, b):
    (pa, ma), (pb, mb) = a, b
    return all(torch.equal(u, v) for u, v in zip(pa, pb)) and torch.equal(ma, mb)


@pytest.mark.gpu
@pytest.mark.parametrize("backward", ["manual", "auto"])
def test_k1_every_cluster_size_is_size_one_bit_for_bit(backward):
    dev = _cuda()
    plist, x, c, _ = _inputs(dev)
    one = tft.fused_call(plist, x, c, 4, CFG, LossWeights(), 5, 1e-3, backward=backward,
                         cluster=1)
    assert tft.fused_call.cluster == 1
    for cs in (2, 4, 8, 16, 0):
        out = tft.fused_call(plist, x, c, 4, CFG, LossWeights(), 5, 1e-3, backward=backward,
                             cluster=cs)
        assert tft.fused_call.cluster == (cs or tft.fused_call.cluster)
        assert tft.fused_call.cluster in (1, 2, 4, 8, 16)
        assert _same(out, one), f"cluster {cs}"


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 135, 1000])
def test_k1_any_row_count_matches_plain(rows):
    """Row counts off the fixtures' 16-134: one row, one past sce4's, and
    more rows than a CTA's largest product block (256), against the plain
    version at K1_TOL's one-epoch numbers, at the picked size and at 16."""
    dev = _cuda()
    w = np.cumsum(np.random.default_rng(rows).normal(0, 1, (rows, 10, 3)), axis=1)
    x, c = tft.fused_inputs(w.astype(np.float32), dev)
    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (rows, 8)).astype(np.float32)).to(dev)
    pp, mp = tft._fused_call_plain(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, eps)
    for cs in (0, 16):
        pk, mk = tft.fused_call(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, eps, cluster=cs)
        assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-4
        assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=1e-5)


@pytest.mark.gpu
def test_k1_impossible_cluster_size_raises():
    """The wrapper refuses a size outside {0, 1, 2, 4, 8, 16}; the launch
    itself, asked for one past the wrapper, fails and raises: no launch
    falls back to another size or to one block."""
    dev = _cuda()
    plist, x, c, _ = _inputs(dev)
    before = tft.fused_call.launches
    with pytest.raises(ValueError, match="cluster must be one of"):
        tft.fused_call(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, cluster=32)
    for cs in (32, 3):
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            tft._fused_call_kernel(plist, x, c, 0, CFG, LossWeights(), 1, 1e-3, None,
                                   cluster=cs)
    assert tft.fused_call.launches == before
