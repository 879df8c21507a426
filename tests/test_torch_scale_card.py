"""Kernels K3 and K4 on the card, against their plain versions.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_scale_card.py -q

Tolerances as in chip_smoke.py (``K3_TOL``, ``K4_TOL``): one epoch, params
atol 1e-5 wherever the epoch's |g| ≥ 1e-6 (there the first Adam step
lr·g/(|g|+1e-8) is lr·sign(g) in both, so only float32 rounding of the
params is left; below it, as in tests/test_torch_fused_scale.py, a
gradient at rounding noise moves its element by up to one step) and
metrics rtol 1e-5 (float32) or 1e-4 (bf16); float32, five epochs, params atol 1e-4 (a tenth of one
Adam step) and metrics rtol 1e-4; K4's gradients to 1e-5 (float32) or 1e-2
(bf16) of each array's max and its loss row to 1e-5 (float32) or 1e-4
(bf16).  A block runs ceil(steps / SMs) 32-row steps, so only corpora of
more than 132·32 = 4224 rows carry a block's sums from one step to the
next: the 5000- and 9000-row cases do.
"""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft

CFG = CVAEConfig()
LW = LossWeights()
# (params atol after one epoch, loss rtol of K3's metrics and K4's row,
# K4's gradients as a fraction of each array's max)
TOL = {None: (1e-5, 1e-5, 1e-5), "bfloat16": (1e-5, 1e-4, 1e-2)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corpus(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def _inputs(dev, n, tile, cd, noise, epochs):
    w = _corpus(n)
    eps = (np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
           if noise == "packed" else None)
    nv, packed = fs._scale_inputs(w, CFG, tile, cd, eps, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    eps_all = (fs.hbm_noise(4, epochs, packed.shape[0], 8, cd, dev)
               if noise == "hbm" else None)
    return plist, packed, float(nv), eps_all


@pytest.mark.gpu
@pytest.mark.parametrize("n,tile,cd,noise", [
    (600, 64, None, "packed"),
    (1000, 256, None, "prng"),        # ragged: 1000 rows padded to 1024
    (13, 8, None, "hbm"),             # one step, mostly padding
    (600, 64, "bfloat16", "hbm"),
    (600, 64, "bfloat16", "packed"),
    (5000, 256, None, "prng"),        # two steps a block
    (9000, 512, "bfloat16", "hbm"),   # three steps a block
])
def test_k3_one_epoch_matches_plain(n, tile, cd, noise):
    dev = _cuda()
    plist, packed, nv, eps_all = _inputs(dev, n, tile, cd, noise, 1)
    args = (plist, packed, 4, CFG, LW, 1, 1e-3, tile, nv, cd, noise, eps_all)
    before = fs._fused_scale_call.launches
    pk, mk = fs._fused_scale_call(*args)
    assert fs._fused_scale_call.launches == before + 1
    pp, mp = fs._fused_scale_call_plain(*args)
    src = fs._eps_source(noise, CFG, tile, packed.shape[0], eps_all, 4, dev)
    gp, _ = fs._plain_grad_epoch(plist, packed, tile, CFG, LW, nv, cd, src)
    p_tol, m_tol, _ = TOL[cd]
    for a, b, g in zip(pk, pp, gp):
        big = g.abs() >= 1e-6
        assert float(torch.where(big, (a - b).abs(), 0.0).max()) <= p_tol
    assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=m_tol)
    assert np.all(mk[:, 5:].cpu().numpy() == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,tile,cd,noise", [
    (1000, 256, None, "prng"),
    (600, 64, None, "packed"),
    (600, 64, "bfloat16", "hbm"),
    (5000, 256, None, "prng"),
    (9000, 512, "bfloat16", "hbm"),
])
def test_k4_matches_plain(n, tile, cd, noise):
    dev = _cuda()
    plist, packed, nv, eps_all = _inputs(dev, n, tile, cd, noise, 1)
    before = fs._grad_epoch_call.launches
    gk, rk = fs._grad_epoch_call(plist, packed, 21, CFG, LW, tile, nv, cd, noise, eps_all)
    assert fs._grad_epoch_call.launches == before + 1
    src = fs._eps_source(noise, CFG, tile, packed.shape[0], eps_all, 21, dev)
    gp, rp = fs._plain_grad_epoch(plist, packed, tile, CFG, LW, nv, cd, src)
    _, m_tol, g_tol = TOL[cd]
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= g_tol * max(float(b.abs().max()), 1e-12)
    assert np.allclose(rk[0, :5].cpu().numpy(), rp.cpu().numpy(), rtol=m_tol)


@pytest.mark.gpu
def test_k3_five_epochs_of_several_steps_a_block_match_plain():
    dev = _cuda()
    plist, packed, nv, eps_all = _inputs(dev, 9000, 512, None, "packed", 5)
    args = (plist, packed, 4, CFG, LW, 5, 1e-3, 512, nv, None, "packed", eps_all)
    pk, mk = fs._fused_scale_call(*args)
    pp, mp = fs._fused_scale_call_plain(*args)
    assert max(float((a - b).abs().max()) for a, b in zip(pk, pp)) <= 1e-4
    assert np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=1e-4)


@pytest.mark.gpu
def test_trainers_run_through_the_kernels_and_descend():
    dev = _cuda()
    w = _corpus(2048)
    k3, k4 = fs._fused_scale_call.launches, fs._grad_epoch_call.launches
    _, h3 = fs.fused_train_scale(w, epochs=10, tile=256, device=dev)
    _, h4 = fs.fused_train_scale_dp(w, epochs=10, tile=256, device=dev)
    assert fs._fused_scale_call.launches == k3 + 1
    assert fs._grad_epoch_call.launches == k4 + 10
    for h in (h3, h4):
        assert np.all(np.isfinite(h["total"])) and h["total"][-1] < h["total"][0]


@pytest.mark.gpu
def test_scale_wrappers_refuse_bad_inputs():
    dev = _cuda()
    plist, packed, nv, eps_all = _inputs(dev, 64, 16, None, "hbm", 1)
    with pytest.raises(ValueError, match="contiguous"):
        fs._fused_scale_call(plist, packed.to(torch.bfloat16), 0, CFG, LW, 1, 1e-3, 16,
                             nv, None, "hbm", eps_all.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of tile"):
        fs._fused_scale_call(plist, packed, 0, CFG, LW, 1, 1e-3, 48, nv, None, "hbm",
                             eps_all)
    with pytest.raises(ValueError, match="compiled for"):
        fs._grad_epoch_call(plist, packed, 0, CVAEConfig(hidden_dim=64), LW, 16, nv,
                            None, "hbm", eps_all)


# ---- the product engine (tensor cores, bf16 weight copy, deferred weight
# gradients) at chunk-ragged sizes: 9000 rows pad to 9152 (tiles of 352:
# 286 steps, chunks of 3 on 132 SMs, the last of 1) or 10240 (tiles of
# 2048: 320 steps, the last chunk of 2)

def _k3_k4_gaps(dev, n, tile, cd, noise, drop_step=None):
    """K3 (one epoch) and K4 against their plain versions → whether each
    holds TOL's limits; with ``drop_step`` the plain versions leave that
    32-row step's rows out (mask 0), a deliberate error."""
    plist, packed, nv, eps_all = _inputs(dev, n, tile, cd, noise, 1)
    wrong = packed.clone()
    if drop_step is not None:
        wrong[32 * drop_step:32 * (drop_step + 1), 32] = 0  # the mask column
    args = (plist, packed, 4, CFG, LW, 1, 1e-3, tile, nv, cd, noise, eps_all)
    pk, mk = fs._fused_scale_call(*args)
    pp, mp = fs._fused_scale_call_plain(plist, wrong, *args[2:])
    src = fs._eps_source(noise, CFG, tile, packed.shape[0], eps_all, 4, dev)
    gp, rp = fs._plain_grad_epoch(plist, wrong, tile, CFG, LW, nv, cd, src)
    gk, rk = fs._grad_epoch_call(plist, packed, 4, CFG, LW, tile, nv, cd, noise, eps_all)
    p_tol, m_tol, g_tol = TOL[cd]
    k3_params = all(
        float(torch.where(g.abs() >= 1e-6, (a - b).abs(), 0.0).max()) <= p_tol
        for a, b, g in zip(pk, pp, gp))
    k3_metrics = bool(np.allclose(mk[:, :5].cpu().numpy(), mp[:, :5].cpu().numpy(), rtol=m_tol))
    k4_grads = all(float((a - b).abs().max()) <= g_tol * max(float(b.abs().max()), 1e-12)
                   for a, b in zip(gk, gp))
    k4_row = bool(np.allclose(rk[0, :5].cpu().numpy(), rp.cpu().numpy(), rtol=m_tol))
    return {"k3_params": k3_params, "k3_metrics": k3_metrics, "k4_grads": k4_grads,
            "k4_row": k4_row}


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [352, 2048])
@pytest.mark.parametrize("noise", ["packed", "hbm", "prng"])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_engine_k3_and_k4_match_plain_at_ragged_chunks(cd, noise, tile):
    dev = _cuda()
    k3, k4 = fs._fused_scale_call.launches, fs._grad_epoch_call.launches
    held = _k3_k4_gaps(dev, 9000, tile, cd, noise)
    assert fs._fused_scale_call.launches == k3 + 1
    assert fs._grad_epoch_call.launches == k4 + 1
    assert all(held.values()), held


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_a_plain_version_without_one_step_fails_the_limits(cd):
    """The limits above see one 32-row step's rows left out of 9000."""
    dev = _cuda()
    held = _k3_k4_gaps(dev, 9000, 352, cd, "hbm", drop_step=100)
    assert not held["k3_metrics"] and not held["k4_row"], held


@pytest.mark.gpu
def test_engine_reports_tensor_cores_and_the_layout_of_the_wrappers():
    from defensive_model_vae_tpu_torch.ops._build import load

    _cuda()
    lib = load("fused_scale")
    assert lib.ks_engine() == fs.ENGINE_TENSOR_CORES
    for n_pad, sms in ((131072, 132), (9152, 132), (16, 132), (704, 3)):
        assert lib.ks_chunks(n_pad, sms) == fs.n_chunks(n_pad, sms)
        assert lib.ks_scratch_elems(n_pad, sms) == fs.scratch_elems(n_pad, sms)


@pytest.mark.gpu
def test_bf16_weight_copy_on_the_card_is_the_plain_rounding():
    from defensive_model_vae_tpu_torch.ops._build import load

    dev = _cuda()
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(5), CFG, dev))
    flat = ft.pack_kernel_params(plist)
    pb = torch.empty(flat.numel(), dtype=torch.bfloat16, device=dev)
    lib = load("fused_scale")
    assert lib.ks_weights_bf16(flat.data_ptr(), pb.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(pb, fs.weights_bf16(flat))


@pytest.mark.gpu
def test_k3_float32_digest_is_the_earlier_builds():
    """float32 keeps its bits: every output one FMA chain over k in order."""
    from defensive_model_vae_tpu_torch.scripts import k3_digest as k3d

    dev = _cuda()
    ref = k3d.REFERENCE.get(k3d.sm_count(dev))
    if ref is None:
        pytest.skip("the digests are taken on a 132-SM card")
    assert k3d.digests(dev)["k3_f32_packed"] == ref["k3_f32_packed"]
