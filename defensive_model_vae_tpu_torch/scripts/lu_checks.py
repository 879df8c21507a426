"""The LU kernel's two forms held to each other and to its arithmetic:

    python -m defensive_model_vae_tpu_torch.scripts.lu_checks

``csrc/lu_solve.cu`` solves the tracker's LM systems in two forms (the rows
in registers, ``"reg"``, and ``[H | g]`` in shared memory, ``"smem"``)
that do every element's operations in the same order, so their outputs
must be equal bit for bit.  The systems they are held on
(:func:`cases`):

- the LM systems of the tracker's first solve (:func:`lm_systems`) at the
  serve configuration (n = 40) at ``TRACKER_ROWS`` rows;
- the same at the other orders of the horizon sweep
  (``control/sweep.py::COMBOS``: n = 10, 20, 60) at ``SWEEP_ROWS`` rows;
- a tie case at each order (:func:`tie_case`): column 0's largest |a|
  taken by several rows with alternating signs, every other entry
  non-integer, so that another pivot choice gives other bits;
- the tracker's systems scaled by ``RANGE_SCALE``, out of the range where
  the register form divides without ``/`` (the kernel's note), so that it
  solves them again by the shared-memory form's code.

Each is also held bit for bit to :func:`lu_emulate`, the kernels'
arithmetic written out in torch on the host (float32 divisions, each fmaf
correctly rounded through float64), and on the tie cases the emulation
with the wrong rule (the last of the tied rows) must differ from the
kernel.  Prints one JSON line a case.  Needs the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..control import mpc
from ..control import tracker_inputs as tp
from ..control.sweep import COMBOS
from ..ops import lu_solve as lus

TRACKER_ROWS = (1, 16, 38, 134)
SWEEP_ROWS = 16
TIE_ORDERS = tuple(2 * m for _, m in COMBOS)  # 10, 20, 40, 60
TIE_ROWS_BATCH, TIE_VALUE, TIE_DIAG, TIE_SEED = 16, 1.5, 2.0, 0
# the tracker's systems scaled by a power of two past the register form's
# fast divisions (|a| < 2^60), so that it solves them again with '/'
RANGE_SCALE = 2.0 ** 70


def lm_systems(rows: int, dev, cfg: mpc.MPCConfig = tp.CFG):
    """The LM systems (H (B, 2M, 2M), g (B, 2M, 1)) of the tracker's first
    solve at ``cfg`` on the sce4 fixture's windows, B = ``rows``."""
    s0, refs, l0 = tp.inputs(rows, 1, dev, cfg)
    prob = mpc._problem(cfg, dev)
    u = torch.zeros((rows, cfg.control_horizon, 2), device=dev)
    first = torch.ones((), dtype=torch.bool, device=dev)
    r, J = prob.residuals(u, s0, refs[:, 0], l0, prob.du_pair(first), True)
    Jt = J.transpose(1, 2)
    H = Jt @ J + cfg.lm_lambda * prob.eye
    return H.contiguous(), (Jt @ r[:, :, None]).contiguous()


def tie_rows(n: int):
    """The rows that share column 0's largest |a| in :func:`tie_case`: the
    first not row 0 (the pivot moves), and, where n > 34, row 33, which a
    warp's lane 1 holds beside row 1 in the register form."""
    return sorted({1, n // 2, n - 2} | ({33} if n > 34 else set()))


def tie_case(n: int, batch: int = TIE_ROWS_BATCH, seed: int = TIE_SEED):
    """(H (batch, n, n), g (batch, n, 1)) float32 numpy: entries uniform in
    [-1, 1), TIE_DIAG added to the diagonal from row 1 on (so the systems
    are well conditioned), column 0 ±TIE_VALUE (alternating) in
    :func:`tie_rows`."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(-1.0, 1.0, (batch, n, n)).astype(np.float32)
    H[:, np.arange(1, n), np.arange(1, n)] += TIE_DIAG
    rows = tie_rows(n)
    H[:, rows, 0] = TIE_VALUE * (-1.0) ** np.arange(len(rows))
    g = rng.uniform(-1.0, 1.0, (batch, n, 1)).astype(np.float32)
    return H, g


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of float32 tensors, rounded once: the product is exact
    in float64, the sum rounded to odd there (TwoSum's error term picks the
    odd neighbour), and round-to-odd at 53 bits then to nearest at 24 is
    the correctly rounded sum.  Finite values."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def lu_emulate(H: torch.Tensor, g: torch.Tensor, pick: str = "first") -> torch.Tensor:
    """x (B, n, 1) of ``H x = g`` by the kernels' operations in their order
    (LU with partial pivoting, l = a_ik / u_kk, a_ij = fmaf(-l, u_kj, a_ij);
    x_k = y_k / u_kk, y_i = fmaf(-u_ik, x_k, y_i)), the pivot the ``pick``
    ("first", the kernels' rule, or "last") of the rows at the column's
    largest |a|.  Finite float32 inputs, on the host."""
    A = torch.cat([H, g], dim=2).float().cpu().clone()
    B, n = A.shape[0], A.shape[1]
    at = torch.arange(B)
    for k in range(n):
        col = A[:, k:, k].abs()
        hit = col == col.amax(dim=1, keepdim=True)
        idx = torch.arange(k, n).expand(B, -1)
        row = (torch.where(hit, idx, n).amin(dim=1) if pick == "first"
               else torch.where(hit, idx, -1).amax(dim=1))
        rk = A[at, k].clone()
        A[at, k] = A[at, row]
        A[at, row] = rk
        l = A[:, k + 1:, k] / A[:, k:k + 1, k]
        A[:, k + 1:, k + 1:] = _fmaf(-l[:, :, None], A[:, k:k + 1, k + 1:],
                                     A[:, k + 1:, k + 1:])
    y = A[:, :, n].clone()
    for k in range(n - 1, -1, -1):
        xk = y[:, k] / A[:, k, k]
        y[:, k] = xk
        y[:, :k] = _fmaf(-A[:, :k, k], xk[:, None], y[:, :k])
    return y[:, :, None]


def cases(dev):
    """[(name, H, g)] on ``dev``: the tracker's systems, the sweep's other
    orders, the tie cases (the module's note)."""
    out = [(f"tracker_{B}x40", *lm_systems(B, dev)) for B in TRACKER_ROWS]
    for P, M in COMBOS:
        if 2 * M != 2 * tp.CFG.control_horizon:
            cfg = mpc.MPCConfig(prediction_horizon=P, control_horizon=M, dt=tp.CFG.dt)
            out.append((f"sweep_{SWEEP_ROWS}x{2 * M}", *lm_systems(SWEEP_ROWS, dev, cfg)))
    for n in TIE_ORDERS:
        H, g = tie_case(n)
        out.append((f"tie_{TIE_ROWS_BATCH}x{n}", torch.from_numpy(H).to(dev),
                    torch.from_numpy(g).to(dev)))
    H, g = lm_systems(SWEEP_ROWS, dev)
    out.append((f"range_{SWEEP_ROWS}x40", H * RANGE_SCALE, g * RANGE_SCALE))
    return out


def hold(name: str, H: torch.Tensor, g: torch.Tensor) -> dict:
    """One case: the two forms and the emulation, bit for bit; on a tie
    case the wrong rule's emulation unequal.  → its row (``ok`` whether it
    holds)."""
    n = H.shape[1]
    form, bound = lus.instance(n)
    reg, smem = lus.lu_solve(H, g, form="reg"), lus.lu_solve(H, g, form="smem")
    first = lu_emulate(H, g)
    row = {"case": name, "rows": H.shape[0], "order": n, "form": form, "instance": bound,
           "reg_eq_smem": bool(torch.equal(reg, smem)),
           "reg_eq_emulated": bool(torch.equal(reg.cpu(), first)),
           "finite": bool(torch.isfinite(reg).all())}
    ok = row["reg_eq_smem"] and row["reg_eq_emulated"] and row["finite"]
    if name.startswith("tie_"):
        row["wrong_pivot_unequal"] = not torch.equal(reg.cpu(), lu_emulate(H, g, "last"))
        ok = ok and row["wrong_pivot_unequal"]
    row["ok"] = ok
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lu_checks needs a CUDA card")
    dev = torch.device("cuda", 0)
    rows = [hold(*c) for c in cases(dev)]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
