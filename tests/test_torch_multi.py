"""Many training runs at once — K2 (``fused_train_multi``) and K1 on a grid
of seeds (``fused_train_seeds``) — and the multi-seed tracker, against the
JAX package and against the port's single-run paths.

On the CPU the grid wrappers run their plain versions: K2's in JAX's
padded-and-masked form, the seed grid's as K1's plain version once per
seed.  The CUDA kernels are held against these on the card
(tests/test_torch_k2_card.py and chip_smoke.py).  Tolerances:

- against JAX's K2 and seed sweep in interpret mode, with explicit ε and
  JAX's init carried across: params atol 1e-5 and metrics rtol 1e-5, as
  tests/test_fused.py:125-168 holds JAX's grid kernel to its single kernel
  (float32 summed in another order, compounded over a few epochs);
- the masked plain version on padded rows against the unmasked one on each
  run's own rows: padded rows add exact zeros, so only the summation order
  of products of another row count can differ (a 1-row run padded to 38
  goes through another BLAS kernel): params atol 1e-6, metrics rtol 1e-5,
  float32 summation order as above;
- the seed grid against ``fused_train`` per seed: bit for bit (the same
  init, noise and arithmetic), as JAX's contract (fused_trainer.py:673);
- the multi-seed tracker against per-seed calls: 1e-5 m, exact step
  counts (rows are independent; only the batch width differs).  On the
  card the batched products of another width rounded a state two float32
  ulps apart (3.05e-5 m at sce2's 128–256 m), so chip_smoke.py holds the
  same comparison to the JAX package's rtol 1e-5, atol 1e-4
  (tests/test_pipeline.py:99).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.ops import fused_trainer as jft

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_train, fused_train_multi, fused_train_seeds
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.pipeline import (
    default_mpc_cfg, fixture_starts, generate_and_track_from_starts,
    generate_and_track_multi_from_starts)
from defensive_model_vae_tpu_torch.train import load_checkpoint
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy

CFG, LW = CVAEConfig(), LossWeights()
SCE2_CKPT = REPO_ROOT / "results" / "checkpoints" / "sce2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eps(rows, seed):
    return np.random.default_rng(seed).standard_normal((rows, 8)).astype(np.float32)


def _ragged(windows_list):
    """Per-run windows → (x_flat, cond, row offsets) on the CPU."""
    ins = [tft.fused_inputs(w, "cpu") for w in windows_list]
    row_off = np.concatenate([[0], np.cumsum([len(x) for x, _ in ins])]).tolist()
    return torch.cat([x for x, _ in ins]), torch.cat([c for _, c in ins]), row_off


def _init(seeds):
    return tft.stack_flat_params([init_params(torch.Generator().manual_seed(s), CFG, "cpu")
                                  for s in seeds])


def _assert_params_close(jax_params, port_params, atol):
    for name, layer in port_params.items():
        for k, a in layer.items():
            ref = np.asarray(jax_params[name][k]).reshape(a.shape)
            assert np.allclose(a.numpy(), ref, atol=atol), (name, k)


def _assert_history_close(jax_hist, port_hist, rtol):
    for key in tft.FUSED_METRIC_KEYS:
        assert np.allclose(port_hist[key], jax_hist[key], rtol=rtol), key


def test_k2_plain_matches_jax_k2_interpret(all_windows):
    """The port's K2 (plain on the CPU) against JAX's K2 in interpret mode:
    sce1 + sce2 (38 and 16 rows, so sce2 is padded), 3 epochs, explicit ε,
    JAX's per-scenario init PRNGKey(seed + i) carried across."""
    windows = {k: all_windows[k] for k in ("sce1", "sce2")}
    keys, seed, epochs = sorted(windows), 3, 3
    eps = {k: _eps(len(windows[k]), 11 + i) for i, k in enumerate(keys)}
    jp, jh = jft.fused_train_multi(windows, epochs=epochs, seed=seed, eps_by_scenario=eps,
                                   interpret=True)
    j_init = [jft._flatten_params(j_init_params(jax.random.PRNGKey(seed + i), JCVAEConfig()))
              for i in range(len(keys))]
    stacked_np = [np.stack([np.asarray(p[j]) for p in j_init]) for j in range(24)]
    stacked = tft.stack_flat_params(params_from_numpy(stacked_np, "cpu", stacked=True))
    x, c, row_off = _ragged([windows[k] for k in keys])
    e = torch.as_tensor(np.concatenate([eps[k] for k in keys]))
    before = tft._fused_multi_call.launches
    out, metrics = tft._fused_multi_call(stacked, x, c, row_off, [seed, seed + 1], CFG, LW,
                                         epochs, 1e-3, e)
    assert tft._fused_multi_call.launches == before
    assert metrics.shape == (2, epochs, 8) and torch.all(metrics[:, :, 5:] == 0)
    for i, k in enumerate(keys):
        _assert_params_close(jp[k], tft._unflatten_params(tft._run_params(out, i)), 1e-5)
        _assert_history_close(jh[k], tft._history(metrics[i].numpy()), 1e-5)


def test_seed_grid_plain_matches_jax_fused_train_seeds(all_windows):
    """The port's seed grid against JAX ``fused_train_seeds`` in interpret
    mode: 2 seeds of sce2, 2 epochs, explicit ε, JAX's ``_stacked_init``."""
    w, seeds, epochs = all_windows["sce2"], [5, 8], 2
    eps = {s: _eps(len(w), s) for s in seeds}
    jp, jh = jft.fused_train_seeds(w, seeds, epochs=epochs, eps_by_seed=eps, interpret=True)
    j_init = jft._stacked_init(jnp.asarray(seeds, jnp.int32), JCVAEConfig())
    stacked = tft.stack_flat_params(
        params_from_numpy([np.asarray(a) for a in j_init], "cpu", stacked=True))
    x, c = tft.fused_inputs(w, "cpu")
    out, metrics = tft._fused_seeds_call(stacked, x, c, seeds, CFG, LW, epochs, 1e-3,
                                         torch.as_tensor(np.stack([eps[s] for s in seeds])))
    for i, s in enumerate(seeds):
        _assert_params_close(jp[s], tft._unflatten_params(tft._run_params(out, i)), 1e-5)
        _assert_history_close(jh[s], tft._history(metrics[i].numpy()), 1e-5)


@pytest.mark.parametrize("noise", ["eps", "philox"])
def test_masked_padded_plain_equals_unmasked_per_run(all_windows, noise):
    """K2's plain version pads every run to n_max and masks; each run equals
    K1's plain version on its own rows only (a 1-row run included)."""
    runs = [all_windows["sce2"], all_windows["sce1"][3:4], all_windows["sce1"]]
    seeds = [4, 9, 2]
    x, c, row_off = _ragged(runs)
    eps = torch.as_tensor(_eps(len(x), 0)) if noise == "eps" else None
    stacked = _init(seeds)
    out, metrics = tft._fused_multi_call(stacked, x, c, row_off, seeds, CFG, LW, 3, 1e-3, eps)
    for s, (lo, hi) in enumerate(zip(row_off[:-1], row_off[1:])):
        p1, m1 = tft._fused_call_plain(tft._run_params(stacked, s), x[lo:hi], c[lo:hi],
                                       seeds[s], CFG, LW, 3, 1e-3,
                                       None if eps is None else eps[lo:hi])
        for a, b in zip(tft._run_params(out, s), p1):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)
        assert torch.allclose(metrics[s], m1, rtol=1e-5, atol=0)


def test_fused_train_multi_is_fused_train_per_scenario(all_windows):
    """Scenario i of ``fused_train_multi(seed)`` is ``fused_train`` on its
    own windows with seed + i (init and noise), to the padded plain
    version's summation order (params atol 1e-6, metrics rtol 1e-5)."""
    windows = {k: all_windows[k] for k in ("sce2", "sce1")}
    params, hist = fused_train_multi(windows, epochs=4, seed=6, device="cpu")
    assert list(params) == ["sce1", "sce2"]
    for i, k in enumerate(sorted(windows)):
        p1, h1 = fused_train(windows[k], epochs=4, seed=6 + i, device="cpu")
        for name in p1:
            for leaf in ("w", "b"):
                assert torch.allclose(params[k][name][leaf], p1[name][leaf], rtol=0,
                                      atol=1e-6)
        _assert_history_close(h1, hist[k], 1e-5)
        assert hist[k]["total"].shape == (4,)


def test_fused_train_seeds_is_fused_train_per_seed_bit_for_bit(all_windows):
    w = all_windows["sce2"]
    params, hist = fused_train_seeds(w, [3, 11, 7], epochs=3, device="cpu")
    assert list(params) == [3, 11, 7]
    for s in (3, 11, 7):
        p1, h1 = fused_train(w, epochs=3, seed=s, device="cpu")
        assert all(torch.equal(params[s][n][k], p1[n][k]) for n in p1 for k in ("w", "b"))
        assert all(np.array_equal(hist[s][k], h1[k]) for k in h1)


def test_fused_train_seeds_explicit_eps_is_fused_train(all_windows):
    w = all_windows["sce2"]
    eps = {s: _eps(len(w), s) for s in (1, 2)}
    params, hist = fused_train_seeds(w, [1, 2], epochs=2, eps_by_seed=eps, device="cpu")
    p1, h1 = fused_train(w, epochs=2, seed=2, eps=eps[2], device="cpu")
    assert all(torch.equal(params[2][n][k], p1[n][k]) for n in p1 for k in ("w", "b"))
    assert np.array_equal(hist[2]["total"], h1["total"])


def test_fused_train_seeds_refuses_duplicate_seeds(all_windows):
    with pytest.raises(ValueError, match="duplicate seeds"):
        fused_train_seeds(all_windows["sce2"], [1, 2, 1], epochs=1, device="cpu")


@pytest.mark.parametrize("row_off,runs", [
    ([0, 20, 54], 3),       # one offset too few for the runs
    ([0, 0, 54], 2),        # an empty run
    ([0, 30, 20, 54], 3),   # offsets that fall
    ([1, 20, 54], 2),       # not from row 0
    ([0, 20, 50], 2),       # not to the last row
])
def test_k2_refuses_bad_row_offsets(row_off, runs):
    x, c = torch.zeros((54, 30)), torch.zeros((54, 2))
    with pytest.raises(ValueError, match="row offsets"):
        tft._fused_multi_call(_init(range(runs)), x, c, row_off, list(range(runs)), CFG,
                              LW, 1, 1e-3)


@pytest.mark.parametrize("call", ["multi", "seeds"])
def test_grid_wrappers_never_fall_back(call, all_windows):
    """A CUDA request without CUDA raises; a tensor on another device is
    refused; the CPU path is the plain version and counts no launch."""
    w = all_windows["sce2"]
    train = {"multi": lambda **kw: fused_train_multi({"sce2": w}, **kw),
             "seeds": lambda **kw: fused_train_seeds(w, [0, 1], **kw)}[call]
    wrapper = {"multi": tft._fused_multi_call, "seeds": tft._fused_seeds_call}[call]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(epochs=1)
    x = torch.zeros((4, 30), device="meta")
    stacked = tuple(a.to("meta") for a in _init([0]))
    args = ([0, 4],) if call == "multi" else ()
    with pytest.raises(ValueError, match="CUDA or"):
        wrapper(stacked, x, x, *args, [0], CFG, LW, 1, 1e-3)
    before = wrapper.launches
    train(epochs=2, device="cpu")
    assert wrapper.launches == before


def test_params_from_numpy_stacked_is_per_run():
    runs = [init_params(torch.Generator().manual_seed(s), CFG, "cpu") for s in (0, 1)]
    stacked = [a.numpy() for a in tft.stack_flat_params(runs)]
    back = params_from_numpy(stacked, "cpu", stacked=True)
    assert len(back) == 2
    for r, b in zip(runs, back):
        assert all(torch.equal(r[n][k], b[n][k]) for n in r for k in ("w", "b"))
    nested = {n: {k: np.stack([r[n][k].numpy() for r in runs]) for k in ("w", "b")}
              for n in runs[0]}
    assert torch.equal(params_from_numpy(nested, "cpu", stacked=True)[1]["dec_3"]["b"],
                       runs[1]["dec_3"]["b"])


def test_multi_seed_tracker_matches_per_seed_calls(all_windows):
    """Several generation seeds in one tracking batch: per-row traces equal
    per-seed calls to 1e-5 m, step counts exactly, start indices exactly."""
    from defensive_model_vae_tpu_torch.control import MPCConfig

    ck, cfg, _ = load_checkpoint(str(SCE2_CKPT), "cpu")
    starts, inits = fixture_starts(all_windows["sce2"][:5])
    mpc = MPCConfig(prediction_horizon=8, control_horizon=4, dt=0.1)
    out = generate_and_track_multi_from_starts(ck, cfg, starts, inits, [0, 7, 3], mpc)
    assert list(out) == [0, 7, 3]
    for s, (traces, idx) in out.items():
        ref_traces, ref_idx = generate_and_track_from_starts(ck, cfg, starts, inits, s, mpc)
        assert np.array_equal(idx, ref_idx) and len(traces) == len(ref_traces) == len(idx)
        for a, b in zip(traces, ref_traces):
            assert a.shape == b.shape
            assert np.abs(a[:, :2] - b[:, :2]).max() <= 1e-5
            assert np.allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("seeds", [[0, 1000], [5, 3005, 7], [2, 2]])
def test_multi_seed_tracker_refuses_aliased_or_duplicate_seeds(seeds):
    with pytest.raises(ValueError, match="aliases|duplicate"):
        generate_and_track_multi_from_starts(None, CFG, np.zeros((1, 2), np.float32),
                                             np.zeros((1, 5)), seeds,
                                             default_mpc_cfg(scenarios.get("sce2")))
