"""The autodiff tier of the port (``backward="auto"``, the ``bf16_chain``
style, K3's ``dwT`` knob) and the scan trainer's siblings, against the JAX
package on the CPU.

On the CPU every kernel wrapper runs its plain version: under
``backward="auto"`` that is autograd of ``_forward_loss`` (per tile for
K3/K4), then Adam; the CUDA instances are held against it on the card
(tests/test_torch_auto_card.py and chip_smoke.py).  The same numpy inputs
and JAX's initial params (``params_from_numpy``) go into both packages.
Tolerances:

- K1/K2 auto vs JAX's kernels in interpret mode: params atol 1e-5, history
  rtol 1e-5 (float32 summed in another order, as tests/test_torch_multi.py);
- K3 auto vs JAX's ``fused_train_scale(backward="auto", interpret=True)``:
  float32 as tests/test_torch_fused_scale.py (params atol 1e-5 where the
  first epoch's |g| ≥ 1e-6, else one Adam step an epoch; history rtol and
  atol 1e-5); ``f32_acts`` rounds each tile's weight gradients to bf16,
  where a float32 ulp apart can round to the neighbouring bf16 value, so
  params atol 1e-4 (a tenth of a step) where |g| ≥ 1e-6 and history rtol
  1e-4;
- ``bf16_chain``'s ``_forward_loss`` vs ``jax.value_and_grad`` of JAX's:
  loss components rtol 1e-5; weight gradients to 1e-2 of each array's max
  (JAX's bf16 rule); bias gradients to 2e-2: XLA's CPU backend sums a bf16
  cotangent with a rounding after every add (its HLO: a reduce-window of
  32 rows in bf16), where the port sums in float32 and rounds once, as the
  TPU's reductions accumulate in float32;
- the scan trainers vs JAX's on JAX's noise (fed in explicitly): float32
  params atol 1e-5 and history rtol 1e-5 after 3 epochs.  bf16: real bf16
  tensors on both sides, rounded in the same places, but a product summed
  in another order can round to the neighbouring bf16 value.  At JAX's
  init logvar reaches [8, 16), where one bf16 ulp is 2^-4 and exp(logvar)
  moves by 6.5%, so the history is held to rtol 7e-2; a gradient near zero
  can change sign, so params are held to the travel of opposite steps
  (2·epochs·lr) and at most 5% of an array's elements over a tenth of a
  step (1e-4; chip_smoke.py's K3_TOL for bf16).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import chip_smoke
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.ops import fused_scale as jfs
from defensive_model_vae_tpu.ops import fused_trainer as jft
from defensive_model_vae_tpu.train import train as jtrain

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_scale as tfs
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.ops.manual_grad import manual_value_and_grad
from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus
from defensive_model_vae_tpu_torch.train import (TrainConfig, train, train_conditioned,
                                                 train_multi_scenario)
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

CFG = CVAEConfig()
LW = LossWeights()
LR = 1e-3

_j_init = jax.jit(j_init_params, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(jp):
    return {k: {q: np.asarray(a) for q, a in v.items()} for k, v in jp.items()}


def _jax_params(seed, cfg=JCVAEConfig()):
    jp = _j_init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(_np_params(jp), "cpu")


def _tiny_corpus(n, seed=3):
    """The corpus of tests/test_fused_scale.py:27."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def _assert_params(ref, got, atol, g0=None, epochs=1):
    """``got`` (port params) within ``atol`` of ``ref`` (JAX's); with
    ``g0`` (|first gradient|, flat), elements under 1e-6 within one Adam
    step an epoch instead."""
    ref = [np.asarray(a) for a in jft._flatten_params(ref)]
    got = [a.numpy() for a in tft._flatten_params(got)]
    for i, (a, b) in enumerate(zip(ref, got)):
        b = b.reshape(a.shape)
        big = np.ones(a.shape, bool) if g0 is None else g0[i].reshape(a.shape) >= 1e-6
        assert np.allclose(a[big], b[big], atol=atol), i
        assert np.allclose(a, b, atol=max(atol, epochs * LR)), i


def _assert_bf16_params(ref, got, epochs):
    """The bf16 rule of the module docstring."""
    ref = [np.asarray(a) for a in jft._flatten_params(ref)]
    got = [a.numpy() for a in tft._flatten_params(got)]
    for i, (a, b) in enumerate(zip(ref, got)):
        gap = np.abs(a - b.reshape(a.shape))
        assert gap.max() <= 2 * epochs * LR and (gap > 1e-4).mean() <= 0.05, i


def _hist(h):
    return np.stack([np.asarray(h[k]) for k in tft.FUSED_METRIC_KEYS], 1)


# ---- K1, K2 and the seed grid under backward="auto" ----------------------------

def test_k1_auto_plain_matches_jax_interpret(all_windows):
    """``fused_call(backward="auto")`` (K1's plain version: autograd, then
    Adam) against JAX's ``_fused_call(backward="auto", interpret=True)``
    on sce2, explicit ε, 3 epochs."""
    w = all_windows["sce2"]
    jp, tp = _jax_params(1)
    eps = np.random.default_rng(21).standard_normal((len(w), 8)).astype(np.float32)
    xj, cj = jft.fused_inputs(w)
    jout, jm = jft._fused_call(tuple(jft._flatten_params(jp)), xj, cj,
                               jnp.array([[1]], jnp.int32), JCVAEConfig(), JLossWeights(),
                               3, LR, eps=jnp.asarray(eps), interpret=True, backward="auto")
    x, c = tft.fused_inputs(w, "cpu")
    before = (tft.fused_call.launches, tft.fused_call.auto_launches)
    out, m = tft.fused_call(tft._flatten_params(tp), x, c, 1, CFG, LW, 3, LR,
                            torch.tensor(eps), backward="auto")
    assert (tft.fused_call.launches, tft.fused_call.auto_launches) == before
    _assert_params(jft._unflatten_params(list(jout)), tft._unflatten_params(out), 1e-5)
    assert np.allclose(m[:, :5].numpy(), np.asarray(jm)[:, :5], rtol=1e-5)


def test_k2_auto_plain_matches_jax_interpret(all_windows):
    """K2's plain version under auto against JAX's ``fused_train_multi(
    backward="auto", interpret=True)``: sce1 + sce2 (sce2 padded), 2 epochs."""
    windows = {k: all_windows[k] for k in ("sce1", "sce2")}
    keys, seed, epochs = sorted(windows), 3, 2
    eps = {k: np.random.default_rng(11 + i).standard_normal((len(windows[k]), 8))
           .astype(np.float32) for i, k in enumerate(keys)}
    jp, jh = jft.fused_train_multi(windows, epochs=epochs, seed=seed, eps_by_scenario=eps,
                                   interpret=True, backward="auto")
    stacked = tft.stack_flat_params(
        [params_from_numpy(_np_params(j_init_params(jax.random.PRNGKey(seed + i),
                                                    JCVAEConfig())), "cpu")
         for i in range(len(keys))])
    ins = [tft.fused_inputs(windows[k], "cpu") for k in keys]
    row_off = [0, len(windows[keys[0]]), len(windows[keys[0]]) + len(windows[keys[1]])]
    out, metrics = tft._fused_multi_call(
        stacked, torch.cat([a for a, _ in ins]), torch.cat([b for _, b in ins]), row_off,
        [seed, seed + 1], CFG, LW, epochs, LR,
        torch.tensor(np.concatenate([eps[k] for k in keys])), backward="auto")
    for i, k in enumerate(keys):
        _assert_params(jp[k], tft._unflatten_params(tft._run_params(out, i)), 1e-5)
        assert np.allclose(metrics[i, :, :5].numpy(), _hist(jh[k]), rtol=1e-5), k


def test_auto_is_another_summation_of_the_same_gradient(all_windows):
    """In float32 the autodiff and manual backwards differ only in
    summation order (JAX ops/manual_grad.py:15-41): one epoch's gradients
    agree to 2e-6 of each array's max, the seed grid under auto is K1
    under auto per seed, and the public trainers take ``backward``."""
    w = all_windows["sce2"]
    _, tp = _jax_params(0)
    x, c = tft.fused_inputs(w, "cpu")
    eps = torch.tensor(np.random.default_rng(5).standard_normal((len(w), 8)),
                       dtype=torch.float32)
    plist = tft._flatten_params(tp)
    ca, ga = tft.autodiff_value_and_grad(plist, x, c, eps, CFG, LW)
    cm, gm = manual_value_and_grad(plist, x, c, eps, CFG, LW)
    assert torch.allclose(ca, cm, rtol=1e-6)
    for a, b in zip(ga, gm):
        assert torch.allclose(a, b, atol=2e-6 * float(b.abs().max()))
    p_s, h_s = tft.fused_train_seeds(w, [2, 7], epochs=2, backward="auto", device="cpu")
    p_1, h_1 = tft.fused_train(w, epochs=2, seed=7, backward="auto", device="cpu")
    assert all(torch.equal(p_s[7][n][k], p_1[n][k]) for n in p_1 for k in ("w", "b"))
    pm, _ = tft.fused_train_multi({"a": w}, epochs=2, seed=7, backward="auto", device="cpu")
    assert all(torch.equal(pm["a"][n][k], p_1[n][k]) for n in p_1 for k in ("w", "b"))
    with pytest.raises(ValueError, match="backward"):
        tft.fused_train(w, epochs=1, backward="traced", device="cpu")


# ---- K3 and K4 under backward="auto" ---------------------------------------------

@pytest.mark.parametrize("cd,atol,rtol", [(None, 1e-5, 1e-5), ("bfloat16", 1e-4, 1e-4)])
def test_k3_auto_plain_matches_jax_interpret(cd, atol, rtol):
    """K3's plain version under auto (float32 and ``f32_acts``) against
    JAX's ``fused_train_scale(backward="auto", interpret=True)`` from JAX's
    init, explicit ε, 24 windows in tiles of 16, 3 epochs (as JAX
    tests/test_fused_scale.py:408-448)."""
    n, tile, epochs = 24, 16, 3
    w = _tiny_corpus(n)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (n, CFG.latent_dim)))
    jp, jh = jfs.fused_train_scale(w, epochs=epochs, tile=tile, compute_dtype=cd, eps=eps,
                                   interpret=True, backward="auto")
    _, tp = _jax_params(0)
    nv, packed = tfs._scale_inputs(w, CFG, tile, cd, eps, torch.device("cpu"))
    out, m = tfs._fused_scale_call(tft._flatten_params(tp), packed, 0, CFG, LW, epochs, LR,
                                   tile, float(nv), cd, "packed", backward="auto")
    x, c = tft.fused_inputs(w, "cpu")
    _, g0 = manual_value_and_grad(tft._flatten_params(tp), x, c, torch.tensor(eps), CFG, LW)
    _assert_params(jp, tft._unflatten_params(out), atol,
                   [g.abs().numpy() for g in g0], epochs)
    assert np.allclose(m[:, :5].numpy(), _hist(jh), rtol=rtol, atol=1e-5)


def test_k4_auto_tier_matches_whole_run():
    """The per-epoch tier under auto (K4's plain version, then Adam) equals
    the whole-run trainer under auto from the same init, in each mode."""
    w = _tiny_corpus(32, seed=9)
    eps = np.random.default_rng(4).standard_normal((32, 8)).astype(np.float32)
    for cd, style in ((None, "f32_acts"), ("bfloat16", "f32_acts"),
                      ("bfloat16", "bf16_chain")):
        kw = dict(epochs=2, tile=16, compute_dtype=cd, mixed_style=style, eps=eps,
                  backward="auto", device="cpu")
        p1, h1 = tfs.fused_train_scale(w, **kw)
        p2, h2 = tfs.fused_train_scale_dp(w, **kw)
        for a, b in zip(tft._flatten_params(p1), tft._flatten_params(p2)):
            assert torch.allclose(a, b, atol=1e-5), (cd, style)
        assert np.allclose(_hist(h1), _hist(h2), rtol=1e-4), (cd, style)


def test_bf16_chain_forward_loss_matches_jax(all_windows):
    """``_forward_loss(mixed_style="bf16_chain")``: values and autograd
    gradients against ``jax.value_and_grad`` of JAX's, on bf16 inputs with
    a mask and a global row count; every weight and bias gradient is an
    exact bf16 value on both sides."""
    w = all_windows["sce4"][:48]
    jp, tp = _jax_params(2)
    eps = np.random.default_rng(8).standard_normal((48, 8)).astype(np.float32)
    mask = np.concatenate([np.ones((44, 1)), np.zeros((4, 1))]).astype(np.float32)
    xj, cj = jft.fused_inputs(w)
    xj, cj = xj.astype(jnp.bfloat16), cj.astype(jnp.bfloat16)

    def loss(pl):
        return jft._forward_loss(pl, xj, cj, jnp.asarray(eps), JCVAEConfig(),
                                 JLossWeights(), jnp.asarray(mask), n_valid=100.0,
                                 compute_dtype=jnp.bfloat16, mixed_style="bf16_chain")

    (_, jc), jg = jax.value_and_grad(loss, has_aux=True)(jft._flatten_params(jp))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    ct = torch.tensor(np.asarray(cj.astype(jnp.float32))).to(torch.bfloat16)
    comps, grads = tft.autodiff_value_and_grad(
        tft._flatten_params(tp), xt, ct, torch.tensor(eps), CFG, LW, torch.tensor(mask),
        100.0, "bfloat16", "bf16_chain")
    assert np.allclose(comps.numpy(), np.asarray(jc), rtol=1e-5)
    for i, (a, b) in enumerate(zip(jg, grads)):
        a, b = np.asarray(a), b.numpy()
        assert np.array_equal(b, torch.tensor(b).to(torch.bfloat16).float().numpy()), i
        tol = (1e-2 if i % 2 == 0 else 2e-2) * max(np.abs(a).max(), 1e-6)
        assert np.allclose(a, b, atol=tol), i
    # f32_acts rounds the weights' gradients only
    _, g_acts = tft.autodiff_value_and_grad(
        tft._flatten_params(tp), xt, ct, torch.tensor(eps), CFG, LW, torch.tensor(mask),
        100.0, "bfloat16", "f32_acts")
    exact = [torch.equal(g, g.to(torch.bfloat16).float()) for g in g_acts]
    assert all(exact[0::2]) and not all(exact[1::2])


@pytest.mark.parametrize("style", ["f32_acts", "bf16_chain"])
def test_one_tile_rounding_check_and_its_wrong_versions(style):
    """chip_smoke.py's K4-auto check on a one-tile corpus of eleven 32-row
    steps: the plain version itself passes it (exact bf16 values, zero
    ulps), and two plain versions with one deliberate error each fail it —
    one whose cotangents pass the roundings unrounded, one that rounds per
    32-row step instead of per tile."""
    n = 352
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = tfs._scale_inputs(scale_corpus(n), CFG, n, "bfloat16", eps, "cpu")
    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, "cpu"))
    src = tfs._eps_source("packed", CFG, n, n, None, 0, packed.device)
    plain, _ = tfs._grad_epoch_call(plist, packed, 0, CFG, LW, n, float(nv), "bfloat16",
                                    "packed", backward="auto", mixed_style=style)
    again, _ = tfs._plain_grad_epoch(plist, packed, n, CFG, LW, float(nv), "bfloat16", src,
                                     backward="auto", mixed_style=style)
    row, ok = chip_smoke.tile_rounding_gaps(plain, again, style)
    assert ok and row["max_ulps"] == 0.0, row
    wrong = chip_smoke.wrong_tile_grads(tfs, tft, plist, packed, CFG, LW, float(nv), style)
    for name, grads in wrong.items():
        row, ok = chip_smoke.tile_rounding_gaps(grads, plain, style)
        assert not ok and not row["weights_bf16_exact"], (name, row)
    assert tft.bf16_rounder("bfloat16")(torch.tensor([1.0 + 2 ** -10])).item() == 1.0


@pytest.mark.parametrize("style", ["f32_acts", "bf16_chain"])
def test_three_tile_rounding_check_and_its_wrong_versions(style):
    """chip_smoke.py's K4-auto check on three tiles of eleven 32-row steps:
    the result on three tiles is the float32 sum of the results on each
    tile alone, bit for bit, and each of those holds exact bf16 values
    within K4's rule of the plain version on that tile.  The plain version
    passes it, and so does the same function summed in another order;
    three plain versions with one deliberate error each fail it — cotangents
    unrounded, rounding per 32-row step, and rounding only the cross-tile
    total of the tiles' float32 sums (which one tile cannot tell from the
    right one)."""
    tile = 352
    n = chip_smoke.TILES_N * tile
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = tfs._scale_inputs(scale_corpus(n), CFG, tile, "bfloat16", eps, "cpu")
    parts = [packed[i:i + tile] for i in range(0, n, tile)]
    plist = tft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, "cpu"))

    def k4a(pk):
        return tfs._grad_epoch_call(plist, pk, 0, CFG, LW, tile, float(nv), "bfloat16",
                                    "packed", backward="auto", mixed_style=style)[0]

    def wrong_of(pk, t=None):
        return chip_smoke.wrong_tile_grads(tfs, tft, plist, pk, CFG, LW, float(nv), style, t,
                                           cross=True)

    sums = chip_smoke.tile_sums(tfs, plist, packed, tile, CFG, LW, float(nv), style)
    whole = k4a(packed)
    row, ok = chip_smoke.tiles_added_gaps(whole, [k4a(pk) for pk in parts], sums, style)
    assert ok and row["per_tile"]["max_ulps"] == 0.0, row
    src = tfs._eps_source("packed", CFG, tile, n, None, 0, packed.device)
    again, _ = tfs._plain_grad_epoch(plist, packed, tile, CFG, LW, float(nv), "bfloat16",
                                     src, backward="auto", mixed_style=style)
    assert chip_smoke.tiles_rounding_gaps(whole, again, sums, style)[0]["max_ulps"] == 0.0
    # the same function with every hidden layer's units reordered (each
    # product summed in another order) keeps the per-tile rule
    order = chip_smoke.per_tile_rows(chip_smoke.reordered_tile_sums(
        tfs, tft, plist, packed, tile, CFG, LW, float(nv), style), sums, style)
    assert order["weights_bf16_exact"] and order["biases_bf16_exact"], order
    assert 0.0 < order["max_rel_to_array_max"] <= order["rel_tol"], order
    w_parts = [wrong_of(pk) for pk in parts]
    w_whole = wrong_of(packed, tile)
    assert set(w_whole) == {"no_rounding", "rounded_per_32_row_step",
                            "rounded_cross_tile_total"}
    for name, grads in w_whole.items():
        row, ok = chip_smoke.tiles_added_gaps(grads, [w[name] for w in w_parts], sums, style)
        assert not ok, (name, row)
    # the reduce that rounds only the total: right on each tile, wrong in the sum
    row, _ = chip_smoke.tiles_added_gaps(w_whole["rounded_cross_tile_total"],
                                         [w["rounded_cross_tile_total"] for w in w_parts],
                                         sums, style)
    assert row["per_tile_pass"] and row["added_frac_unequal"] > 0.01, row


def test_resolve_backward_refusals():
    """JAX's rules (tests/test_fused_scale.py:477-484): None is manual
    where it applies and auto for bf16_chain; manual with bf16_chain and
    unknown names are refused."""
    assert tfs._resolve_backward(None, None, "f32_acts") == "manual"
    assert tfs._resolve_backward(None, "bfloat16", "f32_acts") == "manual"
    assert tfs._resolve_backward(None, "bfloat16", "bf16_chain") == "auto"
    assert tfs._resolve_backward("auto", None, "bf16_chain") == "auto"
    w = _tiny_corpus(16)
    with pytest.raises(ValueError, match="backward"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype=None,
                              backward="handrolled", device="cpu")
    with pytest.raises(ValueError, match="bf16_chain"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype="bfloat16",
                              mixed_style="bf16_chain", backward="manual", device="cpu")
    with pytest.raises(ValueError, match="mixed_style"):
        tfs.fused_train_scale(w, epochs=1, tile=16, mixed_style="bf16", device="cpu")
    params, hist = tfs.fused_train_scale(w, epochs=2, tile=16, compute_dtype="bfloat16",
                                         mixed_style="bf16_chain", noise="prng",
                                         device="cpu")
    assert np.all(np.isfinite(hist["total"]))
    with pytest.raises(ValueError, match="_ablate"):
        tfs._fused_scale_call([], torch.zeros((16, 41)), 0, CFG, LW, 1, LR, 16, 16.0,
                              "bfloat16", "packed", backward="auto", _ablate=("noadam",))


def test_dwT_equals_the_default():
    """K3's dwT knob: ``manual_value_and_grad(dw_mode="transpose")`` is the
    default bit for bit in both dtypes, and so is K3's plain version under
    the knob; the kernel check takes it as a knob of its own."""
    w = _tiny_corpus(32, seed=2)
    eps = np.random.default_rng(3).standard_normal((32, 8)).astype(np.float32)
    _, tp = _jax_params(4)
    plist = tft._flatten_params(tp)
    x, c = tft.fused_inputs(w, "cpu")
    for cd in (None, "bfloat16"):
        a = manual_value_and_grad(plist, x, c, torch.tensor(eps), CFG, LW, compute_dtype=cd)
        b = manual_value_and_grad(plist, x, c, torch.tensor(eps), CFG, LW, compute_dtype=cd,
                                  dw_mode="transpose")
        assert torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    nv, packed = tfs._scale_inputs(w, CFG, 16, "bfloat16", eps, "cpu")
    args = (plist, packed, 0, CFG, LW, 2, LR, 16, float(nv), "bfloat16", "packed")
    p0, m0 = tfs._fused_scale_call(*args)
    p1, m1 = tfs._fused_scale_call(*args, _ablate=("dwT",))
    assert torch.equal(m0, m1) and all(torch.equal(p, q) for p, q in zip(p0, p1))
    assert tfs._check_ablate(("dwT",), "bfloat16") == 64
    tfs._check_kernel_knobs(64, "bfloat16", 16)
    with pytest.raises(ValueError, match="dw_mode"):
        manual_value_and_grad(plist, x, c, torch.tensor(eps), CFG, LW, dw_mode="T")


# ---- the scan trainer's siblings --------------------------------------------------

def _jax_noise(seed, epochs, shape, dtype=jnp.float32):
    """JAX's scan-trainer noise: epoch e draws normal(fold_in(key, e))."""
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, e), shape, dtype)
                                .astype(jnp.float32)) for e in range(epochs)])


def _zero_state(params):
    return {"count": 0,
            "m": {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()},
            "v": {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()}}


@pytest.mark.parametrize("cd,rtol", [(None, 1e-5), ("bfloat16", 7e-2)])
def test_scan_trainer_matches_jax(all_windows, cd, rtol):
    """The scan trainer (float32, and the bf16 chain) against JAX's
    ``train`` from its init on its noise, sce1, 3 epochs."""
    from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig

    w, epochs = all_windows["sce1"], 3
    jp, jh = jtrain(w, train_cfg=JTrainConfig(epochs=epochs, seed=4, compute_dtype=cd))
    p0 = params_from_numpy(_np_params(j_init_params(jax.random.PRNGKey(4), JCVAEConfig())),
                           "cpu")
    eps = _jax_noise(4, epochs, (len(w), 8), jnp.float32 if cd is None else jnp.bfloat16)
    tp, th = train(w, train_cfg=TrainConfig(epochs=epochs, seed=4, compute_dtype=cd),
                   init_state=(p0, _zero_state(p0)), eps=eps, device="cpu")
    if cd is None:
        _assert_params(jp, tp, 1e-5)
    else:
        _assert_bf16_params(jp, tp, epochs)
    assert np.allclose(_hist(th), _hist(jh), rtol=rtol)
    for layer in tp.values():
        assert all(a.dtype == torch.float32 for a in layer.values())


def test_train_conditioned_matches_jax(all_windows):
    """``train_conditioned`` with one extra condition column (cond_dim 3)
    against JAX's, from its init on its noise, sce2, 3 epochs."""
    from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
    from defensive_model_vae_tpu.train import train_conditioned as j_train_conditioned

    w, epochs = all_windows["sce2"], 3
    extra = np.linspace(0.0, 1.0, len(w), dtype=np.float32)[:, None]
    jp, jh, jcfg = j_train_conditioned(w, extra, JTrainConfig(epochs=epochs, seed=6))
    assert jcfg.cond_dim == 3
    p0 = params_from_numpy(_np_params(j_init_params(jax.random.PRNGKey(6), jcfg)), "cpu")
    eps = _jax_noise(6, epochs, (len(w), 8))
    model_cfg = CVAEConfig(cond_dim=3)
    tp, th = train(w, model_cfg, TrainConfig(epochs=epochs, seed=6), extra_cond=extra,
                   init_state=(p0, _zero_state(p0)), eps=eps, device="cpu")
    _assert_params(jp, tp, 1e-5)
    assert np.allclose(_hist(th), _hist(jh), rtol=1e-5)
    p2, h2, cfg2 = train_conditioned(w, extra, TrainConfig(epochs=2), device="cpu")
    assert cfg2 == model_cfg and p2["cond_0"]["w"].shape == (3, 128)
    assert np.all(np.isfinite(h2["total"]))


@pytest.mark.parametrize("cd,rtol", [(None, 1e-5), ("bfloat16", 7e-2)])
def test_train_multi_scenario_matches_jax(all_windows, cd, rtol):
    """``train_multi_scenario`` (one stacked step per epoch over padded,
    masked corpora) against JAX's vmapped one, from its init on its noise:
    sce1 (38 windows) and sce2 (16, padded), 3 epochs."""
    from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
    from defensive_model_vae_tpu.train import train_multi_scenario as j_multi

    windows = {k: all_windows[k] for k in ("sce1", "sce2")}
    epochs, seed, n_max = 3, 2, 38
    jp, jh = j_multi(windows, JTrainConfig(epochs=epochs, seed=seed, compute_dtype=cd))
    keys = list(windows)
    init_keys = jax.random.split(jax.random.PRNGKey(seed), len(keys))
    p0 = {k: params_from_numpy(_np_params(j_init_params(init_keys[i], JCVAEConfig())), "cpu")
          for i, k in enumerate(keys)}
    dt = jnp.float32 if cd is None else jnp.bfloat16
    eps = np.stack([np.stack([np.asarray(jax.random.normal(ks, (n_max, 8), dt).astype(jnp.float32))
                              for ks in jax.random.split(jax.random.fold_in(
                                  jax.random.PRNGKey(seed), e), len(keys))])
                    for e in range(epochs)])
    tp, th = train_multi_scenario(windows, TrainConfig(epochs=epochs, seed=seed,
                                                       compute_dtype=cd),
                                  params_by_scenario=p0, eps=eps, device="cpu")
    for k in keys:
        if cd is None:
            _assert_params(jp[k], tp[k], 1e-5)
        else:
            _assert_bf16_params(jp[k], tp[k], epochs)
        assert np.allclose(_hist(th[k]), _hist(jh[k]), rtol=rtol), k


def test_train_multi_scenario_is_one_step_per_epoch(all_windows):
    """Its own noise and init: model i is seed + i; the two models differ;
    the losses descend."""
    windows = {k: all_windows[k] for k in ("sce2", "sce1")}
    p, h = train_multi_scenario(windows, TrainConfig(epochs=20, seed=3), device="cpu")
    assert list(p) == ["sce2", "sce1"]
    assert not torch.equal(p["sce1"]["enc_0"]["w"], p["sce2"]["enc_0"]["w"])
    assert all(h[k]["total"][-1] < h[k]["total"][0] for k in h)


# ---- the CLI -------------------------------------------------------------------------

@pytest.mark.parametrize("extra,recipe", [
    (["--fused-scale", "--backward", "auto", "--tile", "8"],
     {"trainer": "fused-scale", "backward": "auto", "noise": "hbm"}),
    (["--fused-scale", "--backward", "auto", "--dtype", "bfloat16", "--noise", "prng",
      "--tile", "16", "--mesh"],
     {"trainer": "fused-scale-dp", "backward": "auto", "compute_dtype": "bfloat16",
      "noise": "prng"}),
    (["--dtype", "bfloat16"], {"trainer": "scan", "compute_dtype": "bfloat16"}),
])
def test_cli_backward_auto_and_scan_bf16_recipes(tmp_path, capsys, extra, recipe):
    from defensive_model_vae_tpu_torch.cli import main

    np.save(tmp_path / "w.npy", _tiny_corpus(20))
    ckpt = tmp_path / "ckpt"
    main(["train", "--scenario", "sce2", "--windows", str(tmp_path / "w.npy"),
          "--ckpt", str(ckpt), "--epochs", "2", "--device", "cpu", *extra])
    assert "trained 2 epochs" in capsys.readouterr().out
    got = json.loads((ckpt / "manifest.json").read_text())["recipe"]
    for k, v in recipe.items():
        assert got[k] == v, k
    if recipe["trainer"] == "scan":
        assert "backward" not in got


def test_cli_mesh_needs_fused_scale(tmp_path):
    """--mesh runs the scan trainer over the world (here a world of one) as
    well as --fused-scale's per-epoch tier; only the --fused kernel, one
    device by construction, refuses it."""
    from defensive_model_vae_tpu_torch.cli import main

    np.save(tmp_path / "w.npy", _tiny_corpus(8))
    with pytest.raises(SystemExit, match="--mesh"):
        main(["train", "--scenario", "sce2", "--windows", str(tmp_path / "w.npy"),
              "--ckpt", str(tmp_path / "c"), "--epochs", "1", "--mesh", "--fused",
              "--device", "cpu"])
    main(["train", "--scenario", "sce2", "--windows", str(tmp_path / "w.npy"),
          "--ckpt", str(tmp_path / "c"), "--epochs", "1", "--mesh", "--device", "cpu"])
    got = json.loads((tmp_path / "c" / "manifest.json").read_text())["recipe"]
    assert got["trainer"] == "scan" and got["mesh"] == {"data": 1, "model": 1}


def test_train_config_defaults_are_float32():
    assert TrainConfig().compute_dtype is None
    assert dataclasses.replace(TrainConfig(), compute_dtype="bfloat16").compute_dtype == \
        "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        train(_tiny_corpus(4), train_cfg=TrainConfig(epochs=1, compute_dtype="float16"),
              device="cpu")
