"""Conditional trajectory VAE — plain functions on torch tensors.

Port of ``defensive_model_vae_tpu/models/cvae.py``: the same twelve linear
layers (``CVAEConfig.layer_spec``, :36-64), the same parameter layout
(``{layer: {"w": (in, out), "b": (out,)}}``) and the same windows layout
(``(B, T, D)`` rows of ``[t, x, y]``).  Randomness is explicit: the
initialisation and the latent draws take a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .._device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class CVAEConfig:
    seq_len: int = 10
    dim: int = 3
    latent_dim: int = 8
    hidden_dim: int = 128
    cond_dim: int = 2

    def layer_spec(self) -> Dict[str, Tuple[int, int]]:
        """Layer widths as (in, out) pairs, in forward order (cvae.py:44-64)."""
        H, Z, T, D, C = (self.hidden_dim, self.latent_dim, self.seq_len,
                         self.dim, self.cond_dim)
        return {
            "cond_0": (C, H),
            "cond_1": (H, H),
            "enc_0": (T * D, H),
            "enc_1": (H, H),
            "enc_2": (H, H),
            "enc_3": (H, H),
            "fc_mu": (2 * H, Z),
            "fc_logvar": (2 * H, Z),
            "dec_0": (Z + H, H),
            "dec_1": (H, H),
            "dec_2": (H, H),
            "dec_3": (H, T * D),
        }

    def n_params(self) -> int:
        return sum(fi * fo + fo for fi, fo in self.layer_spec().values())


def init_params(generator: torch.Generator, cfg: CVAEConfig,
                device="cuda") -> Params:
    """torch ``nn.Linear`` default init, U(±1/sqrt(fan_in)) for weight and
    bias (cvae.py:68-82), drawn from ``generator`` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    dev = resolve_device(device)
    out: Params = {}
    for name, (fi, fo) in cfg.layer_spec().items():
        bound = 1.0 / math.sqrt(fi)
        w = (torch.rand((fi, fo), generator=generator) * 2.0 - 1.0) * bound
        b = (torch.rand((fo,), generator=generator) * 2.0 - 1.0) * bound
        out[name] = {"w": w.to(dev), "b": b.to(dev)}
    return out


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def encode_condition(params: Params, condition: torch.Tensor) -> torch.Tensor:
    """(B, cond_dim) → (B, H) condition embedding (cvae.py:93)."""
    h = torch.relu(_linear(params["cond_0"], condition))
    return torch.relu(_linear(params["cond_1"], h))


def encode(params: Params, x: torch.Tensor, condition: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Relative windows (B, T, D) + conditions (B, C) → (mu, logvar, h_cond)
    (cvae.py:99)."""
    h = x.reshape(x.shape[0], -1)
    for name in ("enc_0", "enc_1", "enc_2", "enc_3"):
        h = torch.relu(_linear(params[name], h))
    h_cond = encode_condition(params, condition)
    h_combined = torch.cat([h, h_cond], dim=1)
    return (_linear(params["fc_mu"], h_combined),
            _linear(params["fc_logvar"], h_combined), h_cond)


def reparameterize(generator: torch.Generator, mu: torch.Tensor,
                   logvar: torch.Tensor) -> torch.Tensor:
    """z = mu + sigma * eps (cvae.py:117), eps from a CPU ``generator``."""
    eps = torch.randn(mu.shape, generator=generator).to(mu.device)
    return mu + eps * torch.exp(0.5 * logvar)


def decode(params: Params, z: torch.Tensor, h_condition: torch.Tensor,
           cfg: CVAEConfig) -> torch.Tensor:
    """(B, Z) + (B, H) → relative windows (B, T, D) (cvae.py:124)."""
    h = torch.cat([z, h_condition], dim=1)
    for name in ("dec_0", "dec_1", "dec_2"):
        h = torch.relu(_linear(params[name], h))
    return _linear(params["dec_3"], h).reshape(-1, cfg.seq_len, cfg.dim)


def forward(params: Params, generator: torch.Generator, x_rel: torch.Tensor,
            condition: torch.Tensor, cfg: CVAEConfig):
    """Encode → reparameterize → decode; (recon, mu, logvar, h_cond)
    (cvae.py:135)."""
    mu, logvar, h_cond = encode(params, x_rel, condition)
    z = reparameterize(generator, mu, logvar)
    return decode(params, z, h_cond, cfg), mu, logvar, h_cond


def to_relative(batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute [t, x, y] windows → (relative windows, start points)
    (cvae.py:155): x and y minus the window's first point, t unchanged."""
    start_points = batch[:, 0, 1:3]
    rel = batch.clone()
    rel[:, :, 1:3] -= start_points[:, None, :]
    return rel, start_points.clone()


def sample(params: Params, generator: Optional[torch.Generator],
           start_xy: torch.Tensor, cfg: CVAEConfig,
           z: Optional[torch.Tensor] = None,
           shift_start: bool = True) -> torch.Tensor:
    """Global [t, x, y] trajectories (B, T, D) for start points (B, 2)
    (cvae.py:167).

    z ~ N(0, I) is drawn from the CPU ``generator`` unless ``z`` (B, Z) is
    given — the explicit entry through which tests feed the z the JAX side
    drew.  ``shift_start=False`` is the legacy non-offset decoder, which
    emits absolute coordinates (generate.py:28-33)."""
    start_xy = torch.atleast_2d(start_xy)
    B = start_xy.shape[0]
    if z is None:
        z = torch.randn((B, cfg.latent_dim), generator=generator)
    z = z.to(device=start_xy.device, dtype=torch.float32)
    rel = decode(params, z, encode_condition(params, start_xy), cfg)
    if not shift_start:
        return rel
    out = rel.clone()
    out[:, :, 1:3] += start_xy[:, None, :]
    return out
