"""Full-batch CVAE trainer (the CLI's default, scan-trainer tier).

Port of ``defensive_model_vae_tpu/train/train.py`` (``TrainConfig`` :36,
``train`` :125): every epoch is the absolute→relative transform, the CVAE
forward with fresh reparameterization noise, the four-term loss, its
gradient (autograd), and one Adam step with optax's defaults (b1 0.9,
b2 0.999, eps 1e-8).  The JAX trainer folds the GLOBAL epoch index into its
key; here epoch e's noise comes from a CPU ``torch.Generator`` seeded with
a fold of (seed, e), so a run resumed at ``start_epoch`` continues the noise
stream and chunked training equals one long run.

The mixed-precision dtype, the mesh, and the conditioned, multi-scenario
and Conv1D trainers come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, cvae_loss, init_params, to_relative
from ..models.cvae import decode, encode

_METRIC_KEYS = ("total", "recon", "kld", "start", "time")
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # defaults = reference training config (train.py:36-50)
    epochs: int = 3000
    lr: float = 1e-3
    weights: LossWeights = LossWeights()
    seed: int = 0


def _epoch_seed(seed: int, epoch: int) -> int:
    """The per-epoch generator seed: a fold of (seed, global epoch)."""
    return (seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def epoch_noise(seed: int, epoch: int, shape) -> torch.Tensor:
    """The reparameterization noise of one epoch (CPU float32)."""
    g = torch.Generator().manual_seed(_epoch_seed(seed, epoch))
    return torch.randn(shape, generator=g)


def train(windows: np.ndarray, model_cfg: Optional[CVAEConfig] = None,
          train_cfg: TrainConfig = TrainConfig(),
          init_state: Optional[Tuple[Dict, Dict]] = None,
          return_state: bool = False, start_epoch: int = 0,
          device="cuda"):
    """Train one scenario model on its full window corpus.

    Args:
        windows: (N, T, D) absolute [t, x, y] windows.
        init_state: optional (params, opt_state) to resume from; opt_state
            is ``{"count": int, "m": {...}, "v": {...}}`` as returned with
            ``return_state``.
        start_epoch: epochs already trained when resuming (selects the
            noise of the global epoch index).

    Returns (params, history) — plus opt_state when ``return_state``."""
    dev = resolve_device(device)
    if model_cfg is None:
        model_cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    batch = torch.as_tensor(np.asarray(windows, np.float32)).to(dev)
    x_rel, start = to_relative(batch)
    if init_state is not None:
        params, opt_state = init_state
        params = {k: {n: a.detach().clone().to(dev) for n, a in v.items()}
                  for k, v in params.items()}
        count = int(opt_state["count"])
        m = {k: {n: a.clone().to(dev) for n, a in v.items()} for k, v in opt_state["m"].items()}
        v_ = {k: {n: a.clone().to(dev) for n, a in v.items()} for k, v in opt_state["v"].items()}
    else:
        params = init_params(torch.Generator().manual_seed(train_cfg.seed), model_cfg, dev)
        count = 0
        m = {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()}
        v_ = {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()}

    E, B, Z = train_cfg.epochs, batch.shape[0], model_cfg.latent_dim
    noise = torch.stack([epoch_noise(train_cfg.seed, start_epoch + e, (B, Z))
                         for e in range(E)]).to(dev) if E else None
    leaves = [(k, n) for k in params for n in ("w", "b")]
    metrics = torch.zeros((E, 5), dtype=torch.float32, device=dev)
    for e in range(E):
        plist = [params[k][n].requires_grad_(True) for k, n in leaves]
        mu, logvar, hc = encode(params, x_rel, start)
        z = mu + noise[e] * torch.exp(0.5 * logvar)
        recon = decode(params, z, hc, model_cfg)
        total, comps = cvae_loss(recon, x_rel, mu, logvar, train_cfg.weights)
        grads = torch.autograd.grad(total, plist)
        count += 1
        # optax's bias correction 1 - b**count, in float32
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
        with torch.no_grad():
            for (k, n), p, g in zip(leaves, plist, grads):
                m[k][n] = _B1 * m[k][n] + (1 - _B1) * g
                v_[k][n] = _B2 * v_[k][n] + (1 - _B2) * g * g
                upd = (m[k][n] / bc1) / (torch.sqrt(v_[k][n] / bc2) + _ADAM_EPS)
                params[k][n] = p.detach() - train_cfg.lr * upd
            metrics[e] = torch.stack([comps[key].detach() for key in _METRIC_KEYS])
    metrics = metrics.cpu().numpy()
    history = {k: metrics[:, i] for i, k in enumerate(_METRIC_KEYS)}
    if return_state:
        return params, history, {"count": count, "m": m, "v": v_}
    return params, history
