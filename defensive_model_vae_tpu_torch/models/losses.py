"""Conditional-VAE loss — the four-term objective with optional masking.

Port of ``defensive_model_vae_tpu/models/losses.py`` (``cvae_loss`` :47):

- recon:  MSE(recon, x) over all elements
- kld:    -0.5 * mean(1 + logvar - mu² - exp(logvar))
- start:  MSE of the relative start points
- time:   MSE(t₀, 0) + mean(relu(-Δt))

total = w_recon·recon + w_kld·kld + w_start·start + w_time·time.  A mask
(B,) weights each sample row; with all ones the means are the plain ones.
``n_valid``, when given, is the row count every mean divides by in place of
the mask's sum: a data-parallel rank's block then contributes its share of
the global means, and the blocks' losses sum to the full batch's.
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


def _masked_mean(x: torch.Tensor, mask_b: Optional[torch.Tensor],
                 n_valid: Optional[float] = None) -> torch.Tensor:
    if mask_b is None and n_valid is None:
        return torch.mean(x)
    per_sample = x[0].numel() if x.ndim > 1 else 1
    if mask_b is not None:
        x = x * mask_b.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    if n_valid is None:
        return torch.sum(x) / torch.clamp(torch.sum(mask_b) * per_sample, min=1.0)
    return torch.sum(x) / max(float(n_valid) * per_sample, 1.0)


def cvae_loss(recon_x: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
              logvar: torch.Tensor, weights: LossWeights = LossWeights(),
              mask: Optional[torch.Tensor] = None,
              n_valid: Optional[float] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, unweighted components) for (B, T, D) windows."""
    recon_loss = _masked_mean((recon_x - x) ** 2, mask, n_valid)
    kld = -0.5 * _masked_mean(1.0 + logvar - mu ** 2 - torch.exp(logvar), mask, n_valid)
    start_loss = _masked_mean((recon_x[:, 0, 1:3] - x[:, 0, 1:3]) ** 2, mask, n_valid)
    time_start = _masked_mean(recon_x[:, 0, 0] ** 2, mask, n_valid)
    time_diff = recon_x[:, 1:, 0] - recon_x[:, :-1, 0]
    time_loss = time_start + _masked_mean(torch.relu(-time_diff), mask, n_valid)
    total = (weights.recon * recon_loss + weights.kld * kld
             + weights.start * start_loss + weights.time * time_loss)
    return total, {"total": total, "recon": recon_loss, "kld": kld,
                   "start": start_loss, "time": time_loss}
