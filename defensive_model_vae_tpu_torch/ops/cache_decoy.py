"""P3: the cache probe's decoy kernel and its plain version.

Port of the Pallas kernel ``scripts/cache_probe.py::_decoy`` (:102,
``pallas_call`` :112): ``2x + 1`` elementwise over a (128, 128) float32
array.  On CUDA tensors :func:`decoy` launches ``csrc/cache_decoy.cu``
(counted in ``decoy.launches``) or raises; on CPU tensors it runs the plain
version, ``x * 2.0 + 1.0``, which the kernel equals bit for bit (2x is
exact).  ``scripts/cache_probe.py`` launches it between its rounds of
builds, as JAX's probe traces it.

A call is host work around one launch of 128 KB, so the wrapper does as
little as it can: the checks run cheapest first, on properties that build
no Python object (``x.is_cuda``, not ``x.device.type``); the output is
the only allocation; the launch is a CPython function
(``csrc/cache_decoy_py.cpp``), bound once on the first CUDA call, with the
raw stream handle, so no ctypes conversion and no ``Stream`` object enter
a call.
"""

from __future__ import annotations

import torch

from . import _build

SHAPE = (128, 128)

# bound on the first CUDA call: P3's launch and the current-stream lookup
_launch = _raw_stream = None


def _decoy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def _bind():
    global _launch, _raw_stream
    _launch = _build.load_module("cache_decoy", "cache_decoy_ext").launch
    # the handle of PyTorch's current stream on a device: what
    # torch.cuda.current_stream(dev).cuda_stream reads, without building a
    # Stream object (Triton's launcher takes the same route).  It follows
    # torch.cuda.stream(...) and CUDA-graph capture, so the launch is
    # ordered with PyTorch's own work on the device.
    _raw_stream = torch._C._cuda_getCurrentRawStream


def _refuse_or_plain(x: torch.Tensor) -> torch.Tensor:
    """The refusals, cheapest check first, and the CPU's plain version."""
    if x.dtype is not torch.float32:
        raise ValueError("P3 takes a contiguous float32 tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"P3 runs on CUDA or (plain) CPU tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("P3 takes a contiguous float32 tensor")
    return _decoy_plain(x)


def decoy(x: torch.Tensor) -> torch.Tensor:
    """``2x + 1`` of a contiguous float32 tensor."""
    if x.dtype is not torch.float32 or not x.is_cuda or not x.is_contiguous():
        return _refuse_or_plain(x)
    if _launch is None:
        _bind()
    out = torch.empty_like(x)
    err = _launch(x.data_ptr(), out.data_ptr(), x.numel(), _raw_stream(x.get_device()))
    if err:
        raise RuntimeError(f"P3 launch failed: CUDA error {err}")
    decoy.launches += 1
    return out


decoy.launches = 0
