"""The Conv1D VAE trainer and the linear MPC on the card against the CPU.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they also run where only the port's dependencies
are installed:

    python -m pytest --noconftest -m gpu tests/test_torch_conv_card.py -q

Tolerances (``chip_smoke.py``'s ``CONV_TOL`` and ``EDGE_SINE``, where the
reasons are set out): the conv trainer's loss rows to a relative 1e-5 of
each row's largest value over the first ten epochs (summation order only)
and 1e-3 over all twenty (summation order compounded through Adam), its
params to 1e-2 (ten of Adam's steps the other way); the linear MPC's
states to 1e-3 (the card's sin, cos and atan2 round otherwise, compounded
over the closed loop), its inputs within their bounds.
"""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.control import LinearMPCConfig, simulate_tracking
from defensive_model_vae_tpu_torch.data import generate_random_trajectories
from defensive_model_vae_tpu_torch.models import ConvCVAEConfig, init_conv_params
from defensive_model_vae_tpu_torch.train import TrainConfig, params_to_numpy, train_conv
from defensive_model_vae_tpu_torch.train.train import epoch_noise

pytestmark = pytest.mark.gpu

CONV_FIRST_EPOCHS, CONV_FIRST_REL, CONV_METRICS_REL = 10, 1e-5, 1e-3
CONV_PARAMS_ABS, LMPC_STATES_ABS = 1e-2, 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("L,dim", [(16, 2), (15, 3), (50, 2)])
def test_train_conv_card_matches_cpu(L, dim):
    dev = _cuda()
    w = generate_random_trajectories(32, L, 5.0, seed=1).astype(np.float32)
    if dim == 3:
        w = np.concatenate([np.broadcast_to(np.arange(L, dtype=np.float32)[None, :, None]
                                            * 0.1, (32, L, 1)), w], axis=2)
    cfg = ConvCVAEConfig(seq_len=L, dim=dim, channels=(8, 16), hidden_dim=32)
    init = init_conv_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eps = np.stack([epoch_noise(0, e, (32, cfg.latent_dim)).numpy() for e in range(20)])
    tc = TrainConfig(epochs=20)
    pc, hc, _ = train_conv(w, cfg, tc, init_params=init, eps=eps, device="cpu")
    pg, hg, _ = train_conv(w, cfg, tc, init_params=init, eps=eps, device=dev)
    assert all(pg[k][n].is_cuda for k in pg for n in ("w", "b"))
    for k in hc:
        gap = np.abs(hg[k] - hc[k]) / np.abs(hc[k]).max()
        assert gap[:CONV_FIRST_EPOCHS].max() <= CONV_FIRST_REL, k
        assert gap.max() <= CONV_METRICS_REL, k
    a, b = params_to_numpy(pg), params_to_numpy(pc)
    assert max(float(np.abs(a[k][n] - b[k][n]).max()) for k in a for n in ("w", "b")) \
        <= CONV_PARAMS_ABS


def test_linear_mpc_card_matches_cpu():
    dev = _cuda()
    R, v, n = 60.0, 3.0, 700
    ang = np.linspace(-np.pi / 2, np.pi, n)
    x, y = R * np.cos(ang), R * np.sin(ang)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    ref = np.column_stack([x, y, np.full(n, v), yaw]).astype(np.float32)
    x0 = np.array([x[0], y[0], v, yaw[0]], np.float32)
    cfg = LinearMPCConfig()
    sg, ug = simulate_tracking(cfg, ref, x0, 120, device=dev)
    sc, uc = simulate_tracking(cfg, ref, x0, 120, device="cpu")
    assert np.abs(sg - sc).max() <= LMPC_STATES_ABS
    assert np.all(np.abs(ug) <= np.array([cfg.max_accel, cfg.max_steer], np.float32))
