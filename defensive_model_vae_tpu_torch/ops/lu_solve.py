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

The kernel has two forms with the same arithmetic and so the same bits:
``"reg"``, the rows in registers with the columns unrolled at compile time
(an instance a bound on the order, :data:`REG_BOUNDS`), and ``"smem"``,
``[H | g]`` in shared memory, the first form, for orders up to
:data:`NMAX`.  :func:`instance` picks by the order: the least register
instance that holds it, else ``"smem"``; ``form=`` names one, for the
checks that hold the two forms to each other.  Neither is a fallback for
the other: a failed build or launch raises.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version.  A captured graph launches the kernel at each
replay without running the wrapper, so each form counts its own runs on
the device: :func:`launches` reads those counts and :func:`reset_launches`
sets them to 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# the C side's form numbers (csrc/lu_solve.cu: LU_SMEM, LU_REG)
FORMS = ("smem", "reg")
# the register form's instances, bounds on the order (csrc/lu_solve.cu's
# REG_BOUNDS), and the largest order of either form (LU_NMAX)
REG_BOUNDS = (16, 32, 40, 64)
NMAX = 128


def _lu_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(H, g)[0]


def _check_form(form: Optional[str]) -> None:
    if form is not None and form not in FORMS:
        raise ValueError(f"lu_solve's form is one of {FORMS}, got {form!r}")


def instance(n: int, form: Optional[str] = None) -> Tuple[str, int]:
    """(form, bound) of the kernel instance that solves systems of order
    ``n``: ``form`` if given, else ``"reg"`` up to ``REG_BOUNDS[-1]`` and
    ``"smem"`` above; the register form's least bound that holds ``n``,
    ``NMAX`` for the shared-memory form."""
    _check_form(form)
    if not 1 <= n <= NMAX:
        raise ValueError(f"lu_solve's kernel takes orders 1..{NMAX}, got {n}")
    if form == "smem" or (form is None and n > REG_BOUNDS[-1]):
        return "smem", NMAX
    bound = next((b for b in REG_BOUNDS if n <= b), None)
    if bound is None:
        raise ValueError(f"lu_solve's register form takes orders up to "
                         f"{REG_BOUNDS[-1]}, got {n}")
    return "reg", bound


def lu_solve(H: torch.Tensor, g: torch.Tensor, form: Optional[str] = None) -> torch.Tensor:
    """x (B, n, 1) of ``H x = g`` for H (B, n, n) and g (B, n, 1), float32
    and contiguous; ``form`` as :func:`instance` takes it."""
    _check_form(form)
    if H.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"lu_solve takes float32, got {H.dtype} and {g.dtype}")
    if H.ndim != 3 or H.shape[1] != H.shape[2] or tuple(g.shape) != (*H.shape[:2], 1):
        raise ValueError(f"lu_solve takes H (B, n, n) and g (B, n, 1), got "
                         f"{tuple(H.shape)} and {tuple(g.shape)}")
    if not (H.is_contiguous() and g.is_contiguous()):
        raise ValueError("lu_solve takes contiguous H and g")
    if H.device.type == "cpu" and g.device.type == "cpu":
        return _lu_solve_plain(H, g)
    if H.device.type != "cuda" or g.device != H.device:
        raise ValueError(f"lu_solve runs on CUDA or (plain) CPU tensors, got {H.device} "
                         f"and {g.device}")
    from ._build import load

    B, n = H.shape[0], H.shape[1]
    kind, _ = instance(n, form)
    x = torch.empty_like(g)
    err = load("lu_solve").lu_solve_batched(
        H.data_ptr(), g.data_ptr(), x.data_ptr(), B, n, FORMS.index(kind),
        torch._C._cuda_getCurrentRawStream(H.device.index))
    if err:
        raise RuntimeError(f"lu_solve ({kind}) launch failed at B={B}, n={n}: CUDA error {err}")
    return x


def launches(device, form: Optional[str] = None) -> int:
    """The kernel's runs on ``device`` since its last reset, graph replays
    included, read from the device once its work is done: ``form``'s, or
    both forms' together."""
    from ._build import load

    _check_form(form)
    dev = torch.device(device)
    out = (ctypes.c_ulonglong * len(FORMS))()
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("lu_solve").lu_solve_launches(out)
    if err:
        raise RuntimeError(f"reading lu_solve's launch count failed: CUDA error {err}")
    return int(sum(out) if form is None else out[FORMS.index(form)])


def reset_launches(device) -> None:
    """Set both forms' counts on ``device`` to 0."""
    from ._build import load

    dev = torch.device(device)
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("lu_solve").lu_solve_reset_launches()
    if err:
        raise RuntimeError(f"resetting lu_solve's launch count failed: CUDA error {err}")
