"""The numbers that decide a training cell's ``correct``.

- ``loss_gap``: the largest relative gap between the program's total loss
  and the reference's over the job's first ``loss_epochs`` epochs (three,
  or one where the traffic says so: on the dense CVAE's production corpus
  the loss falls five orders of magnitude in three epochs, and Adam's first
  step, about lr·sign(g), turns bf16 round-off in near-zero gradient
  components into relative loss gaps of up to 5e-4 at epochs 2 and 3).
- ``change_gap``: how far the parameters moved over the first three
  epochs of a job, leaf by leaf: the gap between the norm of the program's change and the norm
  of the reference's, over the larger of the reference's norm for that
  leaf and its median over the leaves; the worst leaf.  A leaf whose first
  gradient in the reference is under a thousandth of the median leaf's
  moves by round-off alone and is left out.
"""

from __future__ import annotations

import numpy as np
import torch

FIRST_EPOCHS = 3
STILL_LEAF = 1e-3


def loss_gap(program_losses, reference_losses, epochs: int = FIRST_EPOCHS) -> float:
    p = np.asarray(program_losses, np.float64)[:epochs]
    r = np.asarray(reference_losses, np.float64)[:epochs]
    if len(p) < epochs or not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))


def moving_leaves(grad0):
    g = np.asarray(grad0, np.float64)
    return g >= STILL_LEAF * np.median(g)


def change_gap(program_final, init, reference_final, grad0) -> float:
    keep = moving_leaves(grad0)
    norm = lambda a: float(torch.linalg.vector_norm(a.double()))  # noqa: E731
    ref = np.array([norm(f.to(i.device) - i) for f, i in zip(reference_final, init)])
    prog = np.array([norm(f.to(i.device).float() - i) for f, i in zip(program_final, init)])
    if not np.all(np.isfinite(prog)):
        return float("inf")
    med = np.median(ref[keep])
    gaps = np.abs(prog - ref) / np.maximum(ref, med)
    return float(np.max(gaps[keep]))


def detail(program_losses, reference_losses, program_final, ref: dict) -> dict:
    """Readings beside the compared numbers, for setting limits: each of the
    first epochs' loss gap, and the median leaf's change gap."""
    p = np.asarray(program_losses, np.float64)[:FIRST_EPOCHS]
    r = np.asarray(reference_losses, np.float64)[:FIRST_EPOCHS]
    out = {f"loss_gap_e{i + 1}": float(abs(a - b) / max(abs(b), 1e-30))
           for i, (a, b) in enumerate(zip(p, r))}
    keep = moving_leaves(ref["grad0"])
    norm = lambda a: float(torch.linalg.vector_norm(a.double()))  # noqa: E731
    rn = np.array([norm(f.to(i.device) - i) for f, i in zip(ref["final"], ref["init"])])
    pn = np.array([norm(f.to(i.device).float() - i) for f, i in zip(program_final, ref["init"])])
    gaps = np.abs(pn - rn) / np.maximum(rn, np.median(rn[keep]))
    out["change_gap_median"] = float(np.median(gaps[keep]))
    out["still_leaves"] = int((~keep).sum())
    return out


def training_checks(program_losses, reference_losses, program_final, ref: dict,
                    limits: dict, loss_epochs: int = FIRST_EPOCHS):
    """[{name, value, limit}]: a job's first losses against the reference's,
    and a first-steps job's change against the reference run ``ref``."""
    return [
        {"name": "loss_gap", "value": loss_gap(program_losses, reference_losses, loss_epochs),
         "limit": float(limits["loss_gap"])},
        {"name": "change_gap",
         "value": change_gap(program_final, ref["init"], ref["final"], ref["grad0"]),
         "limit": float(limits["change_gap"])},
    ]
