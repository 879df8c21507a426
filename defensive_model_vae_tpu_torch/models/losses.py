"""Conditional-VAE loss — the four-term objective with optional masking.

Port of ``defensive_model_vae_tpu/models/losses.py`` (``cvae_loss`` :47):

- recon:  MSE(recon, x) over all elements
- kld:    -0.5 * mean(1 + logvar - mu² - exp(logvar))
- start:  MSE of the relative start points
- time:   MSE(t₀, 0) + mean(relu(-Δt))

total = w_recon·recon + w_kld·kld + w_start·start + w_time·time.  A mask
(B,) weights each sample row; with all ones the means are the plain ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    # defaults = reference training config (losses.py:26-32)
    recon: float = 0.1
    kld: float = 0.1
    start: float = 1.0
    time: float = 1.0


def _masked_mean(x: torch.Tensor, mask_b: Optional[torch.Tensor]) -> torch.Tensor:
    if mask_b is None:
        return torch.mean(x)
    m = mask_b.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    per_sample = x[0].numel() if x.ndim > 1 else 1
    return torch.sum(x * m) / torch.clamp(torch.sum(mask_b) * per_sample, min=1.0)


def cvae_loss(recon_x: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
              logvar: torch.Tensor, weights: LossWeights = LossWeights(),
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, unweighted components) for (B, T, D) windows."""
    recon_loss = _masked_mean((recon_x - x) ** 2, mask)
    kld = -0.5 * _masked_mean(1.0 + logvar - mu ** 2 - torch.exp(logvar), mask)
    start_loss = _masked_mean((recon_x[:, 0, 1:3] - x[:, 0, 1:3]) ** 2, mask)
    time_start = _masked_mean(recon_x[:, 0, 0] ** 2, mask)
    time_diff = recon_x[:, 1:, 0] - recon_x[:, :-1, 0]
    time_loss = time_start + _masked_mean(torch.relu(-time_diff), mask)
    total = (weights.recon * recon_loss + weights.kld * kld
             + weights.start * start_loss + weights.time * time_loss)
    return total, {"total": total, "recon": recon_loss, "kld": kld,
                   "start": start_loss, "time": time_loss}
