"""Rounding of product operands to a stated format, forward and backward.

``rounder(fmt)`` returns ``q(x)``: the value rounded to ``fmt`` and held in
float32, whose gradient is the incoming cotangent rounded to ``fmt`` too
(as a cast's transpose is in autodiff).  Formats:

- ``"float32"``: the identity;
- ``"bfloat16"``: round to nearest even;
- ``"float8_e4m3"``: per-tensor scaled e4m3 (the tensor's largest magnitude
  mapped to 448, rounded, scaled back), the quantisation a lower-precision
  path would use.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "float8_e4m3":
        amax = x.detach().abs().max()
        scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown format {fmt!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def rounder(fmt: str):
    if fmt == "float32":
        return lambda x: x
    _round(torch.zeros(1), fmt)  # refuse an unknown format now
    return lambda x: _Round.apply(x, fmt)
