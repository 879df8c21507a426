"""The MPC tracker's batched dense solve (``csrc/lu_solve.cu``) and its
plain version.

:func:`lu_solve` solves the LM step's systems ``H x = g`` of
``control/mpc.py::_Problem.solve`` (H (B, n, n), g (B, n, 1), n = 2M).  It
replaces no Pallas kernel: the JAX package's tracker calls
``jnp.linalg.solve`` inside its jitted program (``control/mpc.py:172``).
The port captures its tracker step as a CUDA graph, and its plain version,
``torch.linalg.solve_ex``, reaches MAGMA's batched LU on the card from some
batch on (38 and 134 rows on an H100), which invalidates the capture; the
kernel is LU with partial pivoting, one warp a system (its source notes the
design and the bound).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version.  A captured graph launches the kernel at each
replay without running the wrapper, so the kernel counts its own runs on
the device: :func:`launches` reads that count and :func:`reset_launches`
sets it to 0.
"""

from __future__ import annotations

import ctypes

import torch


def _lu_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(H, g)[0]


def lu_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (B, n, 1) of ``H x = g`` for H (B, n, n) and g (B, n, 1), float32."""
    if H.device.type == "cpu" and g.device.type == "cpu":
        return _lu_solve_plain(H, g)
    if H.device.type != "cuda" or g.device != H.device:
        raise ValueError(f"lu_solve runs on CUDA or (plain) CPU tensors, got {H.device} "
                         f"and {g.device}")
    if H.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"lu_solve takes float32, got {H.dtype} and {g.dtype}")
    if H.ndim != 3 or H.shape[1] != H.shape[2] or tuple(g.shape) != (*H.shape[:2], 1):
        raise ValueError(f"lu_solve takes H (B, n, n) and g (B, n, 1), got "
                         f"{tuple(H.shape)} and {tuple(g.shape)}")
    if not (H.is_contiguous() and g.is_contiguous()):
        raise ValueError("lu_solve takes contiguous H and g")
    from ._build import load

    lib = load("lu_solve")
    B, n = H.shape[0], H.shape[1]
    if n > lib.lu_solve_nmax():
        raise ValueError(f"lu_solve: systems of order {n} exceed the kernel's "
                         f"{lib.lu_solve_nmax()}")
    x = torch.empty_like(g)
    err = lib.lu_solve_batched(H.data_ptr(), g.data_ptr(), x.data_ptr(), B, n,
                               torch._C._cuda_getCurrentRawStream(H.device.index))
    if err:
        raise RuntimeError(f"lu_solve launch failed at B={B}, n={n}: CUDA error {err}")
    return x


def launches(device) -> int:
    """The kernel's runs on ``device`` since its last reset, graph replays
    included, read from the device once its work is done."""
    from ._build import load

    dev = torch.device(device)
    out = ctypes.c_ulonglong(0)
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("lu_solve").lu_solve_launches(ctypes.byref(out))
    if err:
        raise RuntimeError(f"reading lu_solve's launch count failed: CUDA error {err}")
    return int(out.value)


def reset_launches(device) -> None:
    """Set the kernel's count on ``device`` to 0."""
    from ._build import load

    dev = torch.device(device)
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("lu_solve").lu_solve_reset_launches()
    if err:
        raise RuntimeError(f"resetting lu_solve's launch count failed: CUDA error {err}")
