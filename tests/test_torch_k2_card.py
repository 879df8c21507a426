"""Kernel K2 and K1 on a grid of seeds, on the card, against their plain
versions and against K1's single run.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_k2_card.py -q

Tolerances as ``K1_TOL`` in chip_smoke.py: one epoch with explicit ε,
params atol 1e-4 and metrics rtol 1e-5 (summation order only).  A grid
block runs K1's own code on its own rows and seed, so against K1's single
run it is held bit for bit, as is every cluster size against size 1.
"""

import pathlib

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_train, fused_train_multi, fused_train_seeds
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"
CFG, LW = CVAEConfig(), LossWeights()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _windows(sce):
    return np.load(FIXTURES / f"trajectory_{sce}_cond.npy")


def _ragged(runs, dev, seeds):
    ins = [tft.fused_inputs(w, dev) for w in runs]
    row_off = np.concatenate([[0], np.cumsum([len(x) for x, _ in ins])]).tolist()
    x = torch.cat([a for a, _ in ins]).contiguous()
    c = torch.cat([b for _, b in ins]).contiguous()
    eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (len(x), 8)).astype(np.float32)).to(dev)
    stacked = tft.stack_flat_params(
        [init_params(torch.Generator().manual_seed(s), CFG, dev) for s in seeds])
    return stacked, x, c, row_off, eps


def _assert_k1_tol(kernel, plain):
    (pk, mk), (pp, mp) = kernel, plain
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-4
    assert np.allclose(mk[..., :5].cpu().numpy(), mp[..., :5].cpu().numpy(), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["four_corpora", "one_row_run"])
def test_k2_one_epoch_matches_plain(case):
    dev = _cuda()
    runs = [_windows(s) for s in ("sce1", "sce2", "sce3", "sce4")]
    if case == "one_row_run":
        runs = [runs[3], runs[0][7:8], runs[1]]
    seeds = list(range(5, 5 + len(runs)))
    stacked, x, c, row_off, eps = _ragged(runs, dev, seeds)
    before = tft._fused_multi_call.launches
    kernel = tft._fused_multi_call(stacked, x, c, row_off, seeds, CFG, LW, 1, 1e-3, eps)
    assert tft._fused_multi_call.launches == before + 1
    plain = tft._fused_multi_call_plain(stacked, x, c, row_off, seeds, CFG, LW, 1, 1e-3, eps)
    _assert_k1_tol(kernel, plain)


@pytest.mark.gpu
def test_k2_run_is_k1_on_its_own_rows_bit_for_bit():
    """The ragged design: scenario i of ``fused_train_multi(seed)`` is
    ``fused_train`` on its own windows with seed + i, exactly."""
    _cuda()
    windows = {s: _windows(s) for s in ("sce1", "sce2", "sce3", "sce4")}
    params, hist = fused_train_multi(windows, epochs=20, seed=2)
    for i, k in enumerate(sorted(windows)):
        p1, h1 = fused_train(windows[k], epochs=20, seed=2 + i)
        assert all(torch.equal(params[k][n][q], p1[n][q]) for n in p1 for q in ("w", "b"))
        assert all(np.array_equal(hist[k][m], h1[m]) for m in h1)


@pytest.mark.gpu
def test_seed_grid_of_32_blocks_is_fused_train_per_seed():
    dev = _cuda()
    w = _windows("sce4")
    seeds = list(range(100, 132))
    before = tft._fused_seeds_call.launches
    params, hist = fused_train_seeds(w, seeds, epochs=5, device=dev)
    assert tft._fused_seeds_call.launches == before + 1
    for s in seeds:
        p1, h1 = fused_train(w, epochs=5, seed=s, device=dev)
        assert all(torch.equal(params[s][n][q], p1[n][q]) for n in p1 for q in ("w", "b"))
        assert all(np.array_equal(hist[s][m], h1[m]) for m in h1)


@pytest.mark.gpu
def test_seed_grid_explicit_eps_matches_plain():
    dev = _cuda()
    w = _windows("sce2")
    x, c = tft.fused_inputs(w, dev)
    seeds = [3, 4, 5]
    stacked = tft.stack_flat_params(
        [init_params(torch.Generator().manual_seed(s), CFG, dev) for s in seeds])
    eps = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, len(w), 8)).astype(np.float32)).to(dev)
    kernel = tft._fused_seeds_call(stacked, x, c, seeds, CFG, LW, 1, 1e-3, eps)
    plain = tft._fused_seeds_call_plain(stacked, x, c, seeds, CFG, LW, 1, 1e-3, eps)
    _assert_k1_tol(kernel, plain)


@pytest.mark.gpu
def test_grid_wrappers_refuse_bad_inputs():
    dev = _cuda()
    runs = [_windows("sce2"), _windows("sce1")]
    stacked, x, c, row_off, eps = _ragged(runs, dev, [0, 1])
    with pytest.raises(ValueError, match="contiguous float32"):
        tft._fused_multi_call(stacked, x.double(), c, row_off, [0, 1], CFG, LW, 1, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        tft._fused_multi_call(stacked, x, c, row_off, [0, 1], CFG, LW, 1, 1e-3,
                              eps[:, :4].contiguous())
    with pytest.raises(ValueError, match="compiled for"):
        tft._fused_seeds_call(stacked, x[:16].contiguous(), c[:16].contiguous(), [0, 1],
                              CVAEConfig(hidden_dim=64), LW, 1, 1e-3)


def _same(a, b):
    (pa, ma), (pb, mb) = a, b
    return all(torch.equal(u, v) for u, v in zip(pa, pb)) and torch.equal(ma, mb)


@pytest.mark.gpu
@pytest.mark.parametrize("backward", ["manual", "auto"])
def test_k2_every_cluster_size_is_size_one_bit_for_bit(backward):
    dev = _cuda()
    runs = [_windows(s) for s in ("sce1", "sce2", "sce3", "sce4")]
    seeds = [0, 1, 2, 3]
    stacked, x, c, row_off, _ = _ragged(runs, dev, seeds)
    one = tft._fused_multi_call(stacked, x, c, row_off, seeds, CFG, LW, 5, 1e-3,
                                backward=backward, cluster=1)
    for cs in (2, 4, 8, 16, 0):
        out = tft._fused_multi_call(stacked, x, c, row_off, seeds, CFG, LW, 5, 1e-3,
                                    backward=backward, cluster=cs)
        assert tft._fused_multi_call.cluster in ((cs,) if cs else (1, 2, 4, 8, 16))
        assert _same(out, one), f"cluster {cs}"


@pytest.mark.gpu
@pytest.mark.parametrize("backward", ["manual", "auto"])
def test_seed_grid_every_cluster_size_is_size_one_bit_for_bit(backward):
    dev = _cuda()
    w = _windows("sce4")
    x, c = tft.fused_inputs(w, dev)
    seeds = list(range(8))
    stacked = tft.stack_flat_params(
        [init_params(torch.Generator().manual_seed(s), CFG, dev) for s in seeds])
    one = tft._fused_seeds_call(stacked, x, c, seeds, CFG, LW, 5, 1e-3, backward=backward,
                                cluster=1)
    for cs in (2, 4, 8, 16, 0):
        out = tft._fused_seeds_call(stacked, x, c, seeds, CFG, LW, 5, 1e-3,
                                    backward=backward, cluster=cs)
        assert tft._fused_seeds_call.cluster in ((cs,) if cs else (1, 2, 4, 8, 16))
        assert _same(out, one), f"cluster {cs}"


@pytest.mark.gpu
def test_grid_impossible_cluster_size_raises():
    dev = _cuda()
    runs = [_windows("sce2"), _windows("sce1")]
    stacked, x, c, row_off, _ = _ragged(runs, dev, [0, 1])
    before = (tft._fused_multi_call.launches, tft._fused_seeds_call.launches)
    with pytest.raises(ValueError, match="cluster must be one of"):
        tft._fused_multi_call(stacked, x, c, row_off, [0, 1], CFG, LW, 1, 1e-3, cluster=32)
    with pytest.raises(ValueError, match="cluster must be one of"):
        tft._fused_seeds_call(stacked, x[:16].contiguous(), c[:16].contiguous(), [0, 1],
                              CFG, LW, 1, 1e-3, cluster=6)
    for entry, kernel, rows, off in ((tft._K1_ENTRIES["manual"][1], "K2", len(x), row_off),
                                     (tft._K1_ENTRIES["manual"][2], "K1", 32, None)):
        xs, cs_ = (x, c) if off else (x[:16].contiguous(), c[:16].contiguous())
        with pytest.raises(RuntimeError, match="launch failed"):
            tft._grid_call_kernel(entry, kernel, stacked, xs, cs_, None, [0, 1], CFG, LW, 1,
                                  1e-3, rows, off, 32)
    assert (tft._fused_multi_call.launches, tft._fused_seeds_call.launches) == before
