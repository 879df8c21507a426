"""P3: the cache probe's decoy kernel and its plain version.

Port of the Pallas kernel ``scripts/cache_probe.py::_decoy`` (:102,
``pallas_call`` :112): ``2x + 1`` elementwise over a (128, 128) float32
array.  On CUDA tensors :func:`decoy` launches ``csrc/cache_decoy.cu``
(counted in ``decoy.launches``) or raises; on CPU tensors it runs the plain
version, ``x * 2.0 + 1.0``, which the kernel equals bit for bit (2x is
exact).  ``scripts/cache_probe.py`` launches it between its rounds of
builds, as JAX's probe traces it.
"""

from __future__ import annotations

import torch

SHAPE = (128, 128)


def _decoy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def decoy(x: torch.Tensor) -> torch.Tensor:
    """``2x + 1`` of a contiguous float32 tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("P3 takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return _decoy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"P3 runs on CUDA or (plain) CPU tensors, got {x.device}")
    from ._build import load

    lib = load("cache_decoy")
    out = torch.empty_like(x)
    err = lib.p3_decoy(x.data_ptr(), out.data_ptr(), x.numel(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"P3 launch failed: CUDA error {err}")
    decoy.launches += 1
    return out


decoy.launches = 0
