"""Temporal-convolution conditional VAE for long-horizon windows.

Port of ``defensive_model_vae_tpu/models/conv_cvae.py`` (BASELINE config 3,
"Temporal-conv (Conv1D) VAE over long-horizon windows"): ``ConvCVAEConfig``
:28, ``init_conv_params`` :53, ``conv_encode`` :101, ``conv_decode`` :112,
``conv_forward`` :130, ``conv_sample`` :138.  The parameter layout is JAX's,
``{"conv_i" | "deconv_i": {"w": (K, Cin, Cout), "b": (Cout,)}, <linear>:
{"w": (in, out), "b": (out,)}}``, so ``params_from_numpy`` carries JAX's
params across unchanged.

JAX computes the convolutions in plain XLA (``lax.conv_general_dilated`` /
``lax.conv_transpose``, channels-last); here they are plain torch
(``F.conv1d``, ``F.conv_transpose1d``, channels-first), with three
translations that keep the two packages' numbers equal:

- **layout**: windows stay (B, T, C) at the boundary; the conv stack runs
  (B, C, T), and the flatten before ``enc_proj`` and the reshape after
  ``dec_proj`` are T-major over (T, C), as JAX's channels-last reshapes;
- **stride-2 "SAME"** pads asymmetrically: out = ⌈L/2⌉, total pad =
  max((out − 1)·2 + K − L, 0), lo = total // 2, hi = total − lo (at L = 50,
  K = 5: (1, 2)), so the pad is explicit and the conv unpadded;
- **``lax.conv_transpose(..., "SAME")``** does not flip the kernel: it is a
  correlation of the 2× zero-dilated input padded (3, 2) for K = 5, 2L
  long before the crop to the target length.  ``F.conv_transpose1d`` is a
  correlation with the kernel flipped and the same pad on both sides, so it
  takes the kernel flipped and padding K − 1 − 3 = 1, and its first 2L
  points are JAX's (:func:`_deconv1d`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .cvae import Params, _linear, encode_condition


@dataclasses.dataclass(frozen=True)
class ConvCVAEConfig:
    seq_len: int = 50
    dim: int = 2
    latent_dim: int = 8
    hidden_dim: int = 128
    cond_dim: int = 2
    channels: Tuple[int, ...] = (32, 64, 128)  # stride-2 each
    kernel: int = 5

    @property
    def bottleneck_len(self) -> int:
        L = self.seq_len
        for _ in self.channels:
            L = (L + 1) // 2
        return L

    def layer_spec(self) -> Dict[str, Tuple[int, ...]]:
        """Each layer's weight shape, in JAX's init order (conv_cvae.py:53-74):
        conv (K, Cin, Cout), linear (in, out)."""
        H, Z, K = self.hidden_dim, self.latent_dim, self.kernel
        spec: Dict[str, Tuple[int, ...]] = {}
        cin = self.dim
        for i, c in enumerate(self.channels):
            spec[f"conv_{i}"] = (K, cin, c)
            cin = c
        flat = self.bottleneck_len * self.channels[-1]
        spec["enc_proj"] = (flat, H)
        spec["cond_0"] = (self.cond_dim, H)
        spec["cond_1"] = (H, H)
        spec["fc_mu"] = (2 * H, Z)
        spec["fc_logvar"] = (2 * H, Z)
        spec["dec_proj"] = (Z + H, flat)
        cin = self.channels[-1]
        for i, c in enumerate(tuple(reversed(self.channels[:-1])) + (self.dim,)):
            spec[f"deconv_{i}"] = (K, cin, c)
            cin = c
        return spec

    def n_params(self) -> int:
        return sum(math.prod(s) + s[-1] for s in self.layer_spec().values())


def init_conv_params(generator: torch.Generator, cfg: ConvCVAEConfig,
                     device="cuda") -> Params:
    """U(±1/sqrt(fan_in)) for weight and bias (fan_in = Cin·K for a conv, as
    JAX's ``_init_conv`` :45; in for a linear layer), drawn from a CPU
    ``generator`` so the same seed gives the same weights on every device."""
    dev = resolve_device(device)
    out: Params = {}
    for name, shape in cfg.layer_spec().items():
        fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
        b = (torch.rand((shape[-1],), generator=generator) * 2.0 - 1.0) * bound
        out[name] = {"w": w.to(dev), "b": b.to(dev)}
    return out


def _same_pad(L: int, K: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of a length-L input: (lo, hi)."""
    out = -(-L // stride)
    total = max((out - 1) * stride + K - L, 0)
    return total // 2, total - total // 2


def _conv1d(p, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """(B, Cin, T) → (B, Cout, ⌈T/stride⌉): JAX's ``_conv1d`` (:77)."""
    K = p["w"].shape[0]
    x = F.pad(x, _same_pad(x.shape[-1], K, stride))
    return F.conv1d(x, p["w"].permute(2, 1, 0), p["b"], stride=stride)


def _deconv1d(p, x: torch.Tensor, out_len: int, stride: int = 2) -> torch.Tensor:
    """(B, Cin, L) → (B, Cout, out_len): JAX's ``_deconv1d`` (:88),
    ``lax.conv_transpose`` with "SAME" padding and the kernel unflipped,
    cropped to ``out_len`` ≤ stride·L.  JAX pads the dilated input
    (pad_a, K + stride − 2 − pad_a), pad_a = ⌈(K + stride − 2)/2⌉ (K − 1 when
    stride > K − 1): (3, 2) for K = 5, stride 2.  ``F.conv_transpose1d``
    with padding K − 1 − pad_a pads both sides by pad_a, so its first
    stride·L points are JAX's."""
    K = p["w"].shape[0]
    pad_a = K - 1 if stride > K - 1 else -(-(K + stride - 2) // 2)
    y = F.conv_transpose1d(x, p["w"].flip(0).permute(1, 2, 0), stride=stride,
                           padding=K - 1 - pad_a)
    return y[..., :out_len] + p["b"][:, None]


def _decoder_lens(cfg: ConvCVAEConfig) -> List[int]:
    """The target lengths on the way back up (conv_cvae.py:116-121)."""
    lens, L = [], cfg.seq_len
    for _ in cfg.channels:
        lens.append(L)
        L = (L + 1) // 2
    return list(reversed(lens))


def conv_encode(params: Params, x: torch.Tensor, condition: torch.Tensor,
                cfg: ConvCVAEConfig):
    """(B, T, D) relative windows + (B, C) conditions → (mu, logvar, h_cond)."""
    h = x.transpose(1, 2)
    for i in range(len(cfg.channels)):
        h = torch.relu(_conv1d(params[f"conv_{i}"], h))
    h = h.transpose(1, 2).reshape(h.shape[0], -1)  # T-major, as JAX's NWC
    h = torch.relu(_linear(params["enc_proj"], h))
    h_cond = encode_condition(params, condition)
    hc = torch.cat([h, h_cond], dim=1)
    return _linear(params["fc_mu"], hc), _linear(params["fc_logvar"], hc), h_cond


def conv_decode(params: Params, z: torch.Tensor, h_cond: torch.Tensor,
                cfg: ConvCVAEConfig) -> torch.Tensor:
    """(B, Z) + (B, H) → relative windows (B, T, D)."""
    h = torch.relu(_linear(params["dec_proj"], torch.cat([z, h_cond], dim=1)))
    h = h.reshape(-1, cfg.bottleneck_len, cfg.channels[-1]).transpose(1, 2)
    n = len(cfg.channels)
    for i, L in enumerate(_decoder_lens(cfg)):
        h = _deconv1d(params[f"deconv_{i}"], h, L)
        if i < n - 1:
            h = torch.relu(h)
    return h.transpose(1, 2)


def conv_forward(params: Params, generator: Optional[torch.Generator],
                 x_rel: torch.Tensor, condition: torch.Tensor, cfg: ConvCVAEConfig,
                 eps: Optional[torch.Tensor] = None):
    """Encode → reparameterize → decode; (recon, mu, logvar, h_cond).  The
    noise is drawn from the CPU ``generator`` unless ``eps`` (B, Z) is
    given."""
    mu, logvar, h_cond = conv_encode(params, x_rel, condition, cfg)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator)
    z = mu + torch.exp(0.5 * logvar) * eps.to(device=mu.device, dtype=mu.dtype)
    return conv_decode(params, z, h_cond, cfg), mu, logvar, h_cond


def pad_condition(cond: torch.Tensor, cfg: ConvCVAEConfig) -> torch.Tensor:
    """Zero-pad (B, k) conditions to ``cfg.cond_dim`` columns, as
    ``train_conv`` and ``conv_sample`` do."""
    if cond.shape[1] < cfg.cond_dim:
        cond = F.pad(cond, (0, cfg.cond_dim - cond.shape[1]))
    return cond


def conv_sample(params: Params, generator: Optional[torch.Generator],
                start_xy: torch.Tensor, cfg: ConvCVAEConfig,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absolute trajectories (B, T, D) for start points (B, 2) (:138).

    z ~ N(0, I) is drawn from the CPU ``generator`` unless ``z`` (B, Z) is
    given (the entry through which tests feed JAX's draws).  The start is
    zero-padded to ``cond_dim``; the decoded relative window is shifted by
    it, in columns 1:3 for dim ≥ 3 ([t, x, y]) and in all columns for
    dim 2."""
    start_xy = torch.atleast_2d(start_xy)
    if z is None:
        z = torch.randn((start_xy.shape[0], cfg.latent_dim), generator=generator)
    z = z.to(device=start_xy.device, dtype=torch.float32)
    rel = conv_decode(params, z, encode_condition(params, pad_condition(start_xy, cfg)),
                      cfg)
    if cfg.dim >= 3:
        out = rel.clone()
        out[:, :, 1:3] += start_xy[:, None, :]
        return out
    return rel + start_xy[:, None, :]
