"""The tracker step kernels' work, from the algorithm: operations and bytes
of the form and update kernels (``csrc/mpc_step.cu``) for the serve
cell's counters (batch, steps, P, M, lm_iters), read by
``layer_metrics/mpc_step_roofline.py``.

Frozen here so that a change to the kernels cannot move it.  Per row, an
LM iteration at horizons (P, M) (n = 2M inputs, R = 2(P+1) + 2M residual
rows) is:

- form: the rollout of the iterate (per input two clips, a product and a
  tangent; the v and θ prefix sums; θ's increment, three products), the
  residuals and their cost, J's coefficients (per input A, D and the
  tangent's increment; its prefix sum), J's track entries from their
  structure (a column j < M − 1 nonzero below row j; the held column's
  sums), then H's upper triangle and g over J's nonzero rows (a product
  and a sum a term; the v rows only where both columns are accelerations;
  the Δu rows' two diagonals and λ);
- update: the clipped trial step, its rollout, residuals and cost, the
  accept and the selects of u and λ.

A step adds the applied control's Euler step once.  Bytes: each launch's
inputs read once and its outputs written once (float32 and int32, 4 bytes
each).  Two FLOP a multiply-add; a clip, a compare, a select or a tangent
counts one.
"""

from __future__ import annotations


def _rollout_ops(P: int) -> int:
    return 6 * P + P + 3 * P + P


def _residual_ops(P: int, M: int) -> int:
    R = 2 * (P + 1) + 2 * M
    return 4 * (P + 1) + 6 * M + 2 * R


def form_ops(P: int, M: int) -> int:
    """One row's form kernel at (P, M)."""
    n = 2 * M
    ops = _rollout_ops(P) + _residual_ops(P, M)
    ops += 11 * P + P                                    # A, D, e; kk
    ops += 5 * sum(P - j for j in range(M - 1))          # columns j < M - 1
    ops += sum(5 * (t - M + 1) + 3 for t in range(M, P + 1))  # the held column
    for p in range(n):                                   # H's upper triangle
        for q in range(p, n):
            terms = P - max(p // 2, q // 2)
            ops += 2 * terms * (2 if p % 2 == 0 and q % 2 == 0 else 1)
            ops += (4 if p == q else 2 if q == p + 2 else 0) + (1 if p == q else 0)
    for p in range(n):                                   # g
        ops += 2 * (P - p // 2) * (2 if p % 2 == 0 else 1) + 4
    return ops


def update_ops(P: int, M: int) -> int:
    """One row's update kernel at (P, M), without the applied step."""
    n = 2 * M
    return 3 * n + _rollout_ops(P) + _residual_ops(P, M) + 1 + n + 3


APPLY_OPS = 15  # the Euler step of [x, y, θ, v]: cos, sin, tan and 12 products and sums


def form_bytes(P: int, M: int) -> int:
    n = 2 * M
    return 4 * ((n + 4 + 2 * (P + 1) + 2 + 1 + 1) + (n * n + n + 1))


def update_bytes(P: int, M: int) -> int:
    n = 2 * M
    return 4 * ((n + n + 4 + 2 * (P + 1) + 2 + 1 + 1 + 1) + (n + 1))


APPLY_BYTES = 4 * (4 + 2 + 1)  # the state, the last control and the flag written


def step_flops_bytes(batch: int, P: int, M: int, lm_iters: int):
    """(operations, bytes) of one tracker step of ``batch`` rows: lm_iters
    × (form, update) and the applied control."""
    ops = batch * (lm_iters * (form_ops(P, M) + update_ops(P, M)) + APPLY_OPS)
    nbytes = batch * (lm_iters * (form_bytes(P, M) + update_bytes(P, M)) + APPLY_BYTES)
    return ops, nbytes
