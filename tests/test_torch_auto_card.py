"""The autodiff instances (K1/K2/seed grid, K3 and K4 under
``backward="auto"``), K3's dwT knob and P3 on the card, against their plain
versions.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_auto_card.py -q

Tolerances are chip_smoke.py's (``K1_TOL``, ``k3_auto_tol``, the one-tile
rule of ``tile_rounding_gaps``, the three-tile rule of
``tiles_added_gaps``); the reasons stand beside them there.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import cache_decoy
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus

pytestmark = pytest.mark.gpu

CFG = CVAEConfig()
LW = LossWeights()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plist(dev, seed=0):
    return ft._flatten_params(init_params(torch.Generator().manual_seed(seed), CFG, dev))


def test_k1_auto_matches_plain():
    dev = _cuda()
    w = np.load(scenarios.get("sce2").fixture_windows)
    x, c = ft.fused_inputs(w, dev)
    eps = torch.as_tensor(np.random.default_rng(9).standard_normal((len(w), 8))
                          .astype(np.float32)).to(dev)
    before = ft.fused_call.auto_launches
    pk, mk = ft.fused_call(_plist(dev), x, c, 0, CFG, LW, 1, 1e-3, eps, backward="auto")
    assert ft.fused_call.auto_launches == before + 1
    pp, mp = ft._fused_call_plain(_plist(dev), x, c, 0, CFG, LW, 1, 1e-3, eps,
                                  backward="auto")
    tol = chip_smoke.K1_TOL[1]
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= tol["params_abs"]
    assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(),
                       rtol=tol["metrics_rel"])


def test_k2_and_seed_grid_auto_are_k1_auto_bit_for_bit():
    dev = _cuda()
    corpora = {k: np.load(scenarios.get(k).fixture_windows) for k in ("sce1", "sce2")}
    pm, hm = ft.fused_train_multi(corpora, epochs=5, backward="auto", device=dev)
    ps, hs = ft.fused_train_seeds(corpora["sce2"], [3, 8], epochs=5, backward="auto",
                                  device=dev)
    for runs, hist, one in ((pm, hm, lambda i, k: ft.fused_train(
            corpora[k], epochs=5, seed=i, backward="auto", device=dev)),
                            (ps, hs, lambda i, k: ft.fused_train(
            corpora["sce2"], epochs=5, seed=k, backward="auto", device=dev))):
        for i, k in enumerate(runs):
            p1, h1 = one(i, k)
            assert all(torch.equal(runs[k][n][q], p1[n][q]) for n in p1 for q in ("w", "b"))
            assert all(np.array_equal(hist[k][m], h1[m]) for m in h1)


@pytest.mark.parametrize("cd,style", [(None, "f32_acts"), ("bfloat16", "f32_acts"),
                                      ("bfloat16", "bf16_chain")])
def test_k3_auto_matches_plain(cd, style):
    """Five 352-row tiles (eleven 32-row steps each), one epoch."""
    dev = _cuda()
    n, tile = 1760, 352
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(scale_corpus(n), CFG, tile, cd, eps, dev)
    args = (_plist(dev), packed, 3, CFG, LW, 1, 1e-3, tile, float(nv), cd, "packed", None)
    mode = fs._auto_mode(cd, style)
    before = fs._fused_scale_call.auto_launches[mode]
    kernel = fs._fused_scale_call(*args, backward="auto", mixed_style=style)
    assert fs._fused_scale_call.auto_launches[mode] == before + 1
    _, ok = chip_smoke.k3_gaps(kernel, fs._fused_scale_call_plain(
        *args, backward="auto", mixed_style=style), chip_smoke.k3_auto_tol(cd, 1))
    assert ok


@pytest.mark.parametrize("style", ["f32_acts", "bf16_chain"])
def test_k4_auto_rounds_per_tile(style):
    dev = _cuda()
    n = 352
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(scale_corpus(n), CFG, n, "bfloat16", eps, dev)
    plist = _plist(dev)
    gk, _ = fs._grad_epoch_call(plist, packed, 0, CFG, LW, n, float(nv), "bfloat16",
                                "packed", None, "auto", style)
    src = fs._eps_source("packed", CFG, n, n, None, 0, dev)
    gp, _ = fs._plain_grad_epoch(plist, packed, n, CFG, LW, float(nv), "bfloat16", src,
                                 backward="auto", mixed_style=style)
    row, ok = chip_smoke.tile_rounding_gaps(gk, gp, style)
    assert ok, row
    for name, grads in chip_smoke.wrong_tile_grads(fs, ft, plist, packed, CFG, LW, float(nv),
                                                   style).items():
        assert not chip_smoke.tile_rounding_gaps(grads, gp, style)[1], name


@pytest.mark.parametrize("style", ["f32_acts", "bf16_chain"])
def test_k4_auto_adds_rounded_tile_sums(style):
    dev = _cuda()
    tile = 352
    n = chip_smoke.TILES_N * tile
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(scale_corpus(n), CFG, tile, "bfloat16", eps, dev)
    parts = [packed[i:i + tile] for i in range(0, n, tile)]
    plist = _plist(dev)

    def k4a(pk):
        return fs._grad_epoch_call(plist, pk, 0, CFG, LW, tile, float(nv), "bfloat16",
                                   "packed", None, "auto", style)[0]

    def wrong_of(pk, t=None):
        return chip_smoke.wrong_tile_grads(fs, ft, plist, pk, CFG, LW, float(nv), style, t,
                                           cross=True)

    sums = chip_smoke.tile_sums(fs, plist, packed, tile, CFG, LW, float(nv), style)
    row, ok = chip_smoke.tiles_added_gaps(k4a(packed), [k4a(pk) for pk in parts], sums, style)
    assert ok, row
    w_parts = [wrong_of(pk) for pk in parts]
    for name, grads in wrong_of(packed, tile).items():
        assert not chip_smoke.tiles_added_gaps(grads, [w[name] for w in w_parts], sums,
                                               style)[1], name


def test_dwT_is_the_default_bit_for_bit():
    dev = _cuda()
    n, tile = 1760, 352
    eps = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(scale_corpus(n), CFG, tile, "bfloat16", eps, dev)
    args = (_plist(dev), packed, 3, CFG, LW, 2, 1e-3, tile, float(nv), "bfloat16", "packed")
    a, b = fs._fused_scale_call(*args), fs._fused_scale_call(*args, _ablate=("dwT",))
    assert torch.equal(a[1], b[1]) and all(torch.equal(p, q) for p, q in zip(a[0], b[0]))


def test_p3_is_its_plain_version_bit_for_bit():
    dev = _cuda()
    x = torch.randn(cache_decoy.SHAPE, generator=torch.Generator().manual_seed(4)) * 1e3
    before = cache_decoy.decoy.launches
    got = cache_decoy.decoy(x.to(dev))
    assert cache_decoy.decoy.launches == before + 1
    assert torch.equal(got.cpu(), cache_decoy._decoy_plain(x))
