"""The production-scale trainer (kernels K3 and K4) in the port, against the
JAX package.

On the CPU the K3 and K4 wrappers run their plain versions (per tile the
ported manual backward, summed over the tiles in order; Adam per epoch);
the CUDA kernels are held against those plain versions on the card
(tests/test_torch_scale_card.py and chip_smoke.py).  The same numpy inputs
and JAX's initial params (carried across by ``params_from_numpy``) go into
both packages.  Tolerances:

- ``f32_acts`` manual gradients vs JAX's ``manual_value_and_grad(
  compute_dtype=bfloat16)``: loss components rtol 1e-5; each gradient array
  to 1e-2 of its own max (JAX's own bf16 comparisons): both round the same
  float32 values to bf16, but a value one float32 ulp apart can round to
  the neighbouring bf16 number;
- float32 trainers vs ``fused_scale_reference``: history rtol 1e-5, atol
  1e-5 (as tests/test_fused_scale.py:36); params atol 1e-5 wherever the
  first epoch's |g| ≥ 1e-6.  Below that, Adam's step lr·m̂/(√v̂+1e-8) turns
  summation-order noise in g into a step of either sign, so those elements
  are held to one step per epoch (atol epochs·lr);
- the per-epoch trainer vs the whole-run trainer: params atol 1e-5, history
  rtol 1e-4 (as tests/test_fused_scale.py:534).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.ops import fused_scale as jfs
from defensive_model_vae_tpu.ops import fused_trainer as jft
from defensive_model_vae_tpu.ops.manual_grad import manual_value_and_grad as j_manual

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights
from defensive_model_vae_tpu_torch.ops import fused_scale as tfs
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.ops.manual_grad import manual_value_and_grad
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

CFG = CVAEConfig()
LW = LossWeights()
LR = 1e-3
EPOCHS, TILE, SEED = 3, 8, 5

_j_init = jax.jit(j_init_params, static_argnums=1)
_j_manual = jax.jit(j_manual, static_argnums=(4, 5),
                    static_argnames=("n_valid", "compute_dtype"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_corpus(n, seed=3):
    """The corpus of tests/test_fused_scale.py:27."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def _jax_params(seed):
    jp = _j_init(jax.random.PRNGKey(seed), JCVAEConfig())
    npp = {k: {q: np.asarray(a) for q, a in v.items()} for k, v in jp.items()}
    return jp, params_from_numpy(npp, "cpu")


def _n_pad(n):
    return -(-n // TILE) * TILE


def _prng_stream(n):
    """The prng mode's ε of every epoch and tile, as (epochs, n, Z)."""
    n_tiles = _n_pad(n) // TILE
    return np.stack([
        torch.cat([tft.philox_normal(SEED + e * n_tiles + i, 0, TILE, CFG.latent_dim)
                   for i in range(n_tiles)]).numpy()[:n]
        for e in range(EPOCHS)])


def _eps_cases():
    rng = np.random.default_rng(17)
    out = {}
    for n in (24, 13):
        out[("const", n)] = rng.standard_normal((n, 8)).astype(np.float32)
        full = rng.standard_normal((EPOCHS, _n_pad(n), 8)).astype(np.float32)
        out[("hbm", n)] = full
        out[("per_epoch", n)] = full[:, :n]
    out[("prng", 24)] = _prng_stream(24)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's ``fused_scale_reference`` (float32, tile 8, 3 epochs), computed
    once per module for every (ε, n) case, with the initial gradient of
    each case's first epoch for the tolerance rule above."""
    eps = _eps_cases()
    jp, tp = _jax_params(SEED)
    refs = {}
    for (kind, n), e in eps.items():
        if kind == "hbm":
            continue
        w = _tiny_corpus(n)
        rp, rh = jfs.fused_scale_reference(jp, w, jnp.asarray(e), epochs=EPOCHS, tile=TILE)
        x, c = tft.fused_inputs(w, "cpu")
        e0 = torch.tensor(e[0] if e.ndim == 3 else e)
        _, g0 = manual_value_and_grad(tft._flatten_params(tp), x, c, e0, CFG, LW)
        refs[(kind, n)] = ([np.asarray(a) for a in jft._flatten_params(rp)],
                           np.asarray(rh), [g.abs().numpy() for g in g0])
    return eps, tp, refs


def _assert_params(ref, got, g0, epochs=EPOCHS):
    for a, b, g in zip(ref, got, g0):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        big = g >= 1e-6
        assert np.allclose(a[big], b[big], atol=1e-5)
        assert np.allclose(a, b, atol=epochs * LR)


def _g0(params, w, eps0):
    """|g| of the first epoch at ``params``: full batch, manual backward."""
    x, c = tft.fused_inputs(w, "cpu")
    _, g = manual_value_and_grad(tft._flatten_params(params), x, c,
                                 torch.as_tensor(np.asarray(eps0, np.float32)), CFG, LW)
    return [a.abs().numpy() for a in g]


def _assert_against_oracle(got, ref, g0, epochs):
    _assert_params([a.numpy() for a in tft._flatten_params(ref)],
                   tft._flatten_params(got), g0, epochs)


def _hist(h):
    return np.stack([h[k] for k in tft.FUSED_METRIC_KEYS], 1)


# ---- the f32_acts manual backward -----------------------------------------

@pytest.mark.parametrize("mode", ["full", "mask_nvalid"])
def test_manual_f32_acts_matches_jax_bf16(all_windows, mode):
    w = all_windows["sce3"][:24]
    jp, tp = _jax_params(0)
    eps = np.random.default_rng(12).standard_normal((24, 8)).astype(np.float32)
    mask = np.concatenate([np.ones((20, 1)), np.zeros((4, 1))]).astype(np.float32)
    mask, nv = {"full": (None, None), "mask_nvalid": (mask, 24.0)}[mode]
    xj, cj = jft.fused_inputs(w)
    comps, grads = _j_manual(jft._flatten_params(jp), xj, cj, jnp.asarray(eps),
                             JCVAEConfig(), JLossWeights(),
                             None if mask is None else jnp.asarray(mask), n_valid=nv,
                             compute_dtype=jnp.bfloat16)
    xt, ct = tft.fused_inputs(w, "cpu")
    comps_t, grads_t = manual_value_and_grad(
        tft._flatten_params(tp), xt, ct, torch.tensor(eps), CFG, LW,
        None if mask is None else torch.tensor(mask), n_valid=nv,
        compute_dtype="bfloat16")
    assert np.allclose(np.asarray(comps), comps_t.numpy(), rtol=1e-5)
    assert len(grads_t) == len(grads) == 24
    for a, b in zip(grads, grads_t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.allclose(a, b, atol=1e-2 * max(np.abs(a).max(), 1e-6))
    # and it is a rounding of the float32 gradients, not another function
    _, grads32 = manual_value_and_grad(
        tft._flatten_params(tp), xt, ct, torch.tensor(eps), CFG, LW,
        None if mask is None else torch.tensor(mask), n_valid=nv)
    assert any(not torch.equal(a, b) for a, b in zip(grads_t, grads32))


def test_manual_f32_path_is_unchanged_by_the_dtype_argument(all_windows):
    w = all_windows["sce2"]
    _, tp = _jax_params(0)
    xt, ct = tft.fused_inputs(w, "cpu")
    eps = torch.tensor(np.random.default_rng(3).standard_normal((len(w), 8)), dtype=torch.float32)
    plist = tft._flatten_params(tp)
    c1, g1 = manual_value_and_grad(plist, xt, ct, eps, CFG, LW)
    c2, g2 = manual_value_and_grad(plist, xt, ct, eps, CFG, LW, compute_dtype=None)
    assert torch.equal(c1, c2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    with pytest.raises(ValueError, match="compute_dtype"):
        manual_value_and_grad(plist, xt, ct, eps, CFG, LW, compute_dtype="float16")


# ---- the oracle ---------------------------------------------------------------

@pytest.mark.parametrize("case", [("const", 24), ("const", 13), ("per_epoch", 24),
                                  ("per_epoch", 13)])
def test_fused_scale_reference_matches_jax(jax_refs, case):
    eps, tp, refs = jax_refs
    ref_p, ref_h, g0 = refs[case]
    got_p, got_h = tfs.fused_scale_reference(tp, _tiny_corpus(case[1]), eps[case],
                                             epochs=EPOCHS, tile=TILE)
    assert got_h.shape == (EPOCHS, 5)
    assert np.allclose(got_h, ref_h, rtol=1e-5, atol=1e-5)
    _assert_params(ref_p, tft._flatten_params(got_p), g0)


def test_tiled_oracle_matches_full_batch():
    """Tiling changes only the summation order (tests/test_fused_scale.py:59)."""
    w = _tiny_corpus(24, seed=11)
    eps = np.random.default_rng(2).standard_normal((24, 8)).astype(np.float32)
    _, tp = _jax_params(0)
    p_t, h_t = tfs.fused_scale_reference(tp, w, eps, epochs=3, tile=8)
    p_f, h_f = tfs.fused_scale_reference(tp, w, eps, epochs=3, tile=None)
    for a, b in zip(tft._flatten_params(p_t), tft._flatten_params(p_f)):
        assert np.allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert np.allclose(h_t, h_f, rtol=1e-4, atol=1e-5)


# ---- K3's plain version against JAX ----------------------------------------------

@pytest.mark.parametrize("noise,n", [("packed", 24), ("packed", 13), ("hbm", 24),
                                     ("hbm", 13), ("prng", 24)])
def test_plain_k3_matches_jax_reference(jax_refs, noise, n):
    """``_fused_scale_call`` on CPU tensors (K3's plain version), float32,
    against JAX's tiled oracle fed the same ε: the explicit ε in the corpus
    columns, the explicit hbm stream (padded rows included), or the prng
    mode's Philox stream."""
    eps, tp, refs = jax_refs
    ref_key = {"packed": ("const", n), "hbm": ("per_epoch", n), "prng": ("prng", n)}[noise]
    ref_p, ref_h, g0 = refs[ref_key]
    w = _tiny_corpus(n)
    nv, packed = tfs._scale_inputs(w, CFG, TILE, None,
                                   eps[("const", n)] if noise == "packed" else None,
                                   torch.device("cpu"))
    eps_all = (torch.tensor(eps[("hbm", n)].reshape(-1, 8)) if noise == "hbm" else None)
    before = tfs._fused_scale_call.launches
    out, metrics = tfs._fused_scale_call(tft._flatten_params(tp), packed, SEED, CFG, LW,
                                         EPOCHS, LR, TILE, float(nv), None, noise, eps_all)
    assert tfs._fused_scale_call.launches == before
    assert metrics.shape == (EPOCHS, 8) and np.all(metrics[:, 5:].numpy() == 0)
    assert np.allclose(metrics[:, :5].numpy(), ref_h, rtol=1e-5, atol=1e-5)
    _assert_params(ref_p, out, g0)


def test_fused_train_scale_packed_equals_oracle_from_the_same_init():
    """The public trainer (explicit ε → packed mode) equals the port's oracle
    from the same torch init (tests/test_fused_scale.py:36, :75)."""
    from defensive_model_vae_tpu_torch.models import init_params

    for n in (24, 13):
        w = _tiny_corpus(n, seed=5)
        eps = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
        params, hist = tfs.fused_train_scale(w, epochs=4, tile=8, compute_dtype=None,
                                             eps=eps, device="cpu")
        p0 = init_params(torch.Generator().manual_seed(0), CFG, "cpu")
        ref_p, ref_h = tfs.fused_scale_reference(p0, w, eps, epochs=4, tile=8)
        _assert_against_oracle(params, ref_p, _g0(p0, w, eps), 4)
        assert np.allclose(_hist(hist), ref_h, rtol=1e-5, atol=1e-5)


def test_hbm_stream_is_seeded_per_epoch_and_cast():
    a = tfs.hbm_noise(3, 4, 16, 8, None, "cpu")
    assert a.shape == (64, 8) and a.dtype == torch.float32
    assert torch.equal(a, tfs.hbm_noise(3, 4, 16, 8, None, "cpu"))
    assert not torch.equal(a, tfs.hbm_noise(4, 4, 16, 8, None, "cpu"))
    assert not torch.allclose(a[:16], a[16:32])  # a fresh draw each epoch
    b = tfs.hbm_noise(3, 4, 16, 8, "bfloat16", "cpu")
    assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
    assert tfs.hbm_noise_impl("cpu") != "rbg" and "torch" in tfs.hbm_noise_impl("cpu")


def test_fused_train_scale_hbm_matches_oracle_on_its_stream():
    """The default noise mode equals the oracle fed the same stream, drawn
    again here from the same seed (tests/test_fused_scale.py:116, :148)."""
    from defensive_model_vae_tpu_torch.models import init_params

    w = _tiny_corpus(13, seed=5)
    params, hist = tfs.fused_train_scale(w, epochs=3, tile=8, compute_dtype=None,
                                         seed=2, noise="hbm", device="cpu")
    stream = tfs.hbm_noise(2, 3, 16, 8, None, "cpu").reshape(3, 16, 8)[:, :13]
    p0 = init_params(torch.Generator().manual_seed(2), CFG, "cpu")
    ref_p, ref_h = tfs.fused_scale_reference(p0, w, stream.numpy(), epochs=3, tile=8)
    _assert_against_oracle(params, ref_p, _g0(p0, w, stream[0]), 3)
    assert np.allclose(_hist(hist), ref_h, rtol=1e-5, atol=1e-5)


# ---- K4 ---------------------------------------------------------------------------

def test_plain_k4_tier_matches_whole_run():
    """The per-epoch tier (K4's plain version + Adam) equals the whole-run
    trainer (tests/test_fused_scale.py:534)."""
    w = _tiny_corpus(24, seed=19)
    eps = np.random.default_rng(8).standard_normal((24, 8)).astype(np.float32)
    p_dp, h_dp = tfs.fused_train_scale_dp(w, epochs=3, tile=8, compute_dtype=None,
                                          eps=eps, device="cpu")
    p_wr, h_wr = tfs.fused_train_scale(w, epochs=3, tile=8, compute_dtype=None,
                                       eps=eps, device="cpu")
    for a, b in zip(tft._flatten_params(p_dp), tft._flatten_params(p_wr)):
        assert np.allclose(a.numpy(), b.numpy(), atol=1e-5)
    for k in tft.FUSED_METRIC_KEYS:
        assert np.allclose(h_dp[k], h_wr[k], rtol=1e-4, atol=1e-5)


def test_plain_k4_hbm_matches_oracle_on_its_stream():
    """The per-epoch tier's hbm ε (stream e of the seed, one per epoch)
    equals the full-batch oracle fed that stream (tests/test_fused_scale.py:174)."""
    from defensive_model_vae_tpu_torch.models import init_params

    w = _tiny_corpus(24, seed=7)
    params, hist = tfs.fused_train_scale_dp(w, epochs=3, tile=8, compute_dtype=None,
                                            seed=9, noise="hbm", device="cpu")
    stream = np.stack([
        torch.randn((24, 8), generator=tfs._noise_generator(9, e, "cpu")).numpy()
        for e in range(3)])
    p0 = init_params(torch.Generator().manual_seed(9), CFG, "cpu")
    ref_p, ref_h = tfs.fused_scale_reference(p0, w, stream, epochs=3, tile=None)
    _assert_against_oracle(params, ref_p, _g0(p0, w, stream[0]), 3)
    assert np.allclose(_hist(hist), ref_h, rtol=1e-4, atol=1e-5)


def test_grad_epoch_call_prng_keys_tiles_from_the_base():
    """K4's prng mode keys tile i by base + i: its plain version equals the
    manual backward over each tile's Philox draw, summed."""
    w = _tiny_corpus(24)
    _, tp = _jax_params(0)
    plist = tft._flatten_params(tp)
    nv, packed = tfs._scale_inputs(w, CFG, 8, None, None, torch.device("cpu"))
    grads, row = tfs._grad_epoch_call(plist, packed, 40, CFG, LW, 8, float(nv), None,
                                      "prng")
    assert row.shape == (1, 8) and np.all(row[0, 5:].numpy() == 0)
    x, c = tft.fused_inputs(w, "cpu")
    eps = torch.cat([tft.philox_normal(40 + i, 0, 8, 8) for i in range(3)])
    comps, g_full = manual_value_and_grad(plist, x, c, eps, CFG, LW)
    assert np.allclose(row[0, :5].numpy(), comps.numpy(), rtol=1e-5)
    for a, b in zip(grads, g_full):
        assert np.allclose(a.numpy(), b.numpy(), atol=1e-6 * max(float(b.abs().max()), 1.0))


# ---- bf16 runs ------------------------------------------------------------------

@pytest.mark.parametrize("trainer,noise", [("whole_run", "packed"), ("whole_run", "hbm"),
                                           ("whole_run", "prng"), ("per_epoch", "packed"),
                                           ("per_epoch", "hbm")])
def test_bf16_runs_descend_with_f32_masters(trainer, noise):
    """Mixed precision: finite, descending, float32 masters
    (tests/test_fused_scale.py:97, :222, :555)."""
    n = 32
    w = _tiny_corpus(n, seed=9)
    eps = (np.random.default_rng(6).standard_normal((n, 8)).astype(np.float32)
           if noise == "packed" else None)
    fn = tfs.fused_train_scale if trainer == "whole_run" else tfs.fused_train_scale_dp
    params, hist = fn(w, epochs=6, tile=16, compute_dtype="bfloat16", eps=eps,
                      noise="hbm" if noise == "packed" else noise, device="cpu")
    assert np.all(np.isfinite(hist["total"]))
    assert hist["total"][-1] < hist["total"][0]
    for p in tft._flatten_params(params):
        assert p.dtype == torch.float32 and torch.all(torch.isfinite(p))


def test_bf16_corpus_is_stored_in_bf16():
    w = _tiny_corpus(13)
    nv, packed = tfs._scale_inputs(w, CFG, 16, "bfloat16", None, torch.device("cpu"))
    assert nv == 13 and packed.shape == (16, 33) and packed.dtype == torch.bfloat16
    assert torch.all(packed[:13, 32] == 1) and torch.all(packed[13:] == 0)


# ---- argument refusals (tests/test_fused_scale.py:232, :476, :574) -------------

def test_scale_tile_guards():
    w = _tiny_corpus(16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfs.fused_train_scale(w, epochs=1, tile=8, compute_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        tfs.fused_train_scale(w, epochs=1, tile=12, compute_dtype=None, device="cpu")
    with pytest.raises(ValueError, match="per-tile"):
        tfs.fused_train_scale(w, epochs=1, tile=1 << 16, compute_dtype=None, device="cpu")
    with pytest.raises(ValueError, match="mixed_style"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype="bfloat16",
                              mixed_style="f32-acts", device="cpu")


def test_scale_noise_guards():
    w = _tiny_corpus(16)
    with pytest.raises(ValueError, match="noise"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype=None, noise="vmem",
                              device="cpu")
    # 'packed' is reached only through an explicit eps
    with pytest.raises(ValueError, match="noise"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype=None, noise="packed",
                              device="cpu")
    with pytest.raises(ValueError, match="noise"):
        tfs.fused_train_scale_dp(w, epochs=1, tile=16, compute_dtype=None,
                                 noise="packed", device="cpu")
    with pytest.raises(ValueError, match="GiB for the eps buffer"):
        tfs.fused_train_scale(w, epochs=1 << 22, tile=2048, compute_dtype=None,
                              noise="hbm", device="cpu")
    with pytest.raises(ValueError, match="noise"):
        tfs.fused_train_scale_dp(w, epochs=1, tile=16, compute_dtype=None,
                                 noise="vmem", device="cpu")


def test_scale_backward_guards():
    w = _tiny_corpus(16)
    with pytest.raises(ValueError, match="backward"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype=None,
                              backward="handrolled", device="cpu")
    with pytest.raises(ValueError, match="bf16_chain"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype="bfloat16",
                              mixed_style="bf16_chain", backward="manual", device="cpu")
    with pytest.raises(ValueError, match="not ported yet"):
        tfs.fused_train_scale(w, epochs=1, tile=16, compute_dtype=None,
                              backward="auto", device="cpu")
    assert tfs._resolve_backward(None, "bfloat16", "f32_acts") == "manual"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tfs.fused_train_scale_dp(w, mesh=object(), epochs=1, tile=16, device="cpu")


def test_scale_wrappers_never_fall_back():
    """A CUDA request without CUDA raises; a tensor on another device is
    refused; the CPU path is the plain version and counts no launch."""
    w = _tiny_corpus(16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfs.fused_train_scale(w, epochs=1, tile=16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfs.fused_train_scale_dp(w, epochs=1, tile=16)
    packed = torch.zeros((16, 33), device="meta")
    with pytest.raises(ValueError, match="CUDA or"):
        tfs._fused_scale_call([], packed, 0, CFG, LW, 1, LR, 16, 16.0, None, "prng")
    with pytest.raises(ValueError, match="CUDA or"):
        tfs._grad_epoch_call([], packed, 0, CFG, LW, 16, 16.0, None, "prng")
    with pytest.raises(ValueError, match="eps stream"):
        tfs._fused_scale_call([], torch.zeros((16, 33)), 0, CFG, LW, 1, LR, 16, 16.0,
                              None, "hbm", torch.zeros((4, 8)))
    before = (tfs._fused_scale_call.launches, tfs._grad_epoch_call.launches)
    tfs.fused_train_scale(w, epochs=1, tile=16, device="cpu")
    tfs.fused_train_scale_dp(w, epochs=1, tile=16, device="cpu")
    assert (tfs._fused_scale_call.launches, tfs._grad_epoch_call.launches) == before


# ---- the CLI ------------------------------------------------------------------------

@pytest.mark.parametrize("extra,recipe", [
    ([], {"trainer": "fused-scale", "backward": "manual", "noise": "hbm",
          "noise_impl": "torch.randn/cpu-mt19937"}),
    (["--dtype", "bfloat16", "--mesh", "--noise", "prng", "--tile", "16"],
     {"trainer": "fused-scale-dp", "compute_dtype": "bfloat16", "backward": "manual",
      "noise": "prng"}),
])
def test_cli_train_fused_scale_writes_the_recipe(tmp_path, capsys, extra, recipe):
    from defensive_model_vae_tpu_torch.cli import main

    np.save(tmp_path / "w.npy", _tiny_corpus(20))
    ckpt = tmp_path / "ckpt"
    main(["train", "--scenario", "sce2", "--windows", str(tmp_path / "w.npy"),
          "--ckpt", str(ckpt), "--epochs", "3", "--tile", "8", "--fused-scale",
          "--device", "cpu", *extra])
    assert "trained 3 epochs" in capsys.readouterr().out
    got = json.loads((ckpt / "manifest.json").read_text())["recipe"]
    for k, v in recipe.items():
        assert got[k] == v, k
    if "compute_dtype" not in recipe:
        assert "compute_dtype" not in got
    if recipe["noise"] != "hbm":
        assert "noise_impl" not in got


@pytest.mark.parametrize("argv,msg", [
    (["--fused", "--fused-scale"], "mutually exclusive"),
    (["--noise", "prng"], "--noise applies"),
    (["--backward", "manual"], "--backward applies"),
    (["--fused", "--dtype", "bfloat16"], "--dtype applies"),
    (["--fused", "--mesh"], "one device"),
])
def test_cli_fused_scale_refusals(tmp_path, argv, msg):
    from defensive_model_vae_tpu_torch.cli import main

    np.save(tmp_path / "w.npy", _tiny_corpus(8))
    with pytest.raises(SystemExit, match=msg):
        main(["train", "--scenario", "sce2", "--windows", str(tmp_path / "w.npy"),
              "--ckpt", str(tmp_path / "c"), "--epochs", "1", "--device", "cpu", *argv])
