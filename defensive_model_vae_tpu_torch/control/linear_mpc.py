"""Linear time-varying MPC: a receding-horizon box-QP by projected gradient.

Port of ``defensive_model_vae_tpu/control/linear_mpc.py``
(``LinearMPCConfig`` :34, ``solve_ltv_qp`` :97, ``simulate_tracking`` :146,
``sine_road_demo`` :182), the counterpart of the reference's linear MPC demo
(``MPC/mpc_reference.py``): a 4-state kinematic bicycle [x, y, v, yaw] with
inputs [a, δ], linearized about the current speed and the reference yaw,

    x_{k+1} = A x_k + B u_k + c,

a quadratic tracking cost with the yaw error wrapped to [−π, π], a control
cost, and box bounds on the inputs, solved by ``pg_iters`` projected-gradient
steps from u = 0.

JAX differentiates the rollout with autodiff on every iteration.  Here the
problem is condensed once a solve, as JAX's docstring describes it: the
states over the horizon are affine in the inputs,

    xs = Φ x₀ + Γ u + c̄      (Φ: (T+1, 4, 4), Γ: (4(T+1), 2T)),

so an iteration is one product and its transpose, with no autograd graph:

    e = xs − x_ref (yaw column wrapped),  ∇ = 2 Γᵀ (q ⊙ e) + 2 r ⊙ u,
    u ← clip(u − lr ∇).

The wrap's derivative is taken as 1, which is what JAX's autodiff of
``atan2(sin e, cos e)`` gives up to rounding.  The products run in another
order than JAX's sequential rollout, so the states agree to float32 rounding
compounded over the closed loop (the tests state the tolerance).  The whole
simulation stays on the device: the nearest reference index, the solve and
the nonlinear step of each of its steps.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearMPCConfig:
    # horizon 8, dt 0.1 and the 45° steer bound are the reference demo's;
    # the 4-state model, wheelbase, accel bound and weights JAX's own
    horizon: int = 8
    wheelbase: float = 2.9
    dt: float = 0.1
    max_accel: float = 1.0
    max_steer: float = float(np.deg2rad(45.0))
    q: Tuple[float, float, float, float] = (1.0, 1.0, 0.5, 0.5)  # x, y, v, yaw
    r: Tuple[float, float] = (0.01, 0.01)
    pg_iters: int = 60
    pg_lr: float = 0.5


def _linearize(cfg: LinearMPCConfig, v: torch.Tensor, phi: torch.Tensor,
               delta: torch.Tensor):
    """(A, B, C) of the bicycle linearized about (v, phi, delta), 0-d
    tensors (JAX :49), each term in JAX's order of operations."""
    dt, L = cfg.dt, cfg.wheelbase
    z, o = torch.zeros_like(v), torch.ones_like(v)
    c, s = torch.cos(phi), torch.sin(phi)
    cd2 = torch.cos(delta) ** 2
    A = torch.stack([o, z, dt * c, -dt * v * s,
                     z, o, dt * s, dt * v * c,
                     z, z, o, z,
                     z, z, dt * torch.tan(delta) / L, o]).reshape(4, 4)
    B = torch.stack([z, z, z, z, dt * o, z, z, dt * v / (L * cd2)]).reshape(4, 2)
    C = torch.stack([dt * v * s * phi, -dt * v * c * phi, z, -dt * v * delta / (L * cd2)])
    return A, B, C


def _condense(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, T: int):
    """The rollout's affine map: (Φ (T+1, 4, 4), Γ (4(T+1), 2T), c̄ (T+1, 4))
    with xs[k] = Φ[k] x₀ + Σ_{j<k} A^{k-1-j} B u_j + c̄[k]."""
    powers = [torch.eye(4, dtype=A.dtype, device=A.device)]
    for _ in range(T):
        powers.append(A @ powers[-1])
    Phi = torch.stack(powers)                                   # A^0 .. A^T
    AB = Phi[:T] @ B                                            # (T, 4, 2): A^m B
    cbar = torch.cat([torch.zeros_like(C)[None], torch.cumsum(Phi[:T] @ C, dim=0)])
    k = torch.arange(T + 1, device=A.device)[:, None]
    j = torch.arange(T, device=A.device)[None, :]
    m = (k - 1 - j).clamp(min=0)
    G = AB[m] * (j < k)[:, :, None, None].to(A.dtype)          # (T+1, T, 4, 2)
    return Phi, G.permute(0, 2, 1, 3).reshape(4 * (T + 1), 2 * T), cbar


def _bounds(cfg: LinearMPCConfig, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = torch.tensor([cfg.max_accel, cfg.max_steer], dtype=torch.float32, device=dev)
    return -hi, hi


def _solve(cfg: LinearMPCConfig, x0, x_ref, v_bar, phi_bar, delta_bar) -> torch.Tensor:
    """The projected-gradient solve on tensors of one device → u (T, 2)."""
    T, dev = cfg.horizon, x0.device
    A, B, C = _linearize(cfg, v_bar, phi_bar, delta_bar)
    Phi, G, cbar = _condense(A, B, C, T)
    base = (Phi @ x0) + cbar - x_ref                           # (T+1, 4)
    q2 = 2.0 * torch.tensor(cfg.q, dtype=torch.float32, device=dev)
    r2 = 2.0 * torch.tensor(cfg.r, dtype=torch.float32, device=dev)
    yaw = torch.arange(4, device=dev) == 3
    lo, hi = _bounds(cfg, dev)
    Gt = G.T.contiguous()
    u = torch.zeros((T, 2), dtype=torch.float32, device=dev)
    for _ in range(cfg.pg_iters):
        e = (G @ u.reshape(-1)).reshape(T + 1, 4) + base
        e = torch.where(yaw, torch.atan2(torch.sin(e), torch.cos(e)), e)
        grad = (Gt @ (q2 * e).reshape(-1)).reshape(T, 2) + r2 * u
        u = torch.clamp(u - cfg.pg_lr * grad, lo, hi)
    return u


def solve_ltv_qp(cfg: LinearMPCConfig, x0, x_ref, v_bar, phi_bar, delta_bar,
                 device="cuda") -> np.ndarray:
    """Box-constrained LTV tracking QP by projected gradient (JAX :97).

    Args:
        x0: (4,) current state [x, y, v, yaw].
        x_ref: (T+1, 4) reference states.
        v_bar, phi_bar, delta_bar: the linearization point.

    Returns u: (T, 2) inputs, as numpy."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return _solve(cfg, f32(x0), f32(x_ref), f32(v_bar), f32(phi_bar),
                  f32(delta_bar)).cpu().numpy()


def simulate_tracking(cfg: LinearMPCConfig, reference: np.ndarray, x0: np.ndarray,
                      n_steps: int, device="cuda"):
    """Receding-horizon simulation along a reference path (JAX :146).

    Args:
        reference: (N, 4) reference states [x, y, v, yaw]; the horizon reads
            the rows from the one nearest the vehicle on, the last repeated.
        x0: (4,) initial state.

    Returns (states (n_steps+1, 4), controls (n_steps, 2)) as numpy."""
    dev = resolve_device(device)
    ref = torch.as_tensor(np.asarray(reference, np.float32), device=dev)
    T, dt, L = cfg.horizon, cfg.dt, cfg.wheelbase
    lo, hi = _bounds(cfg, dev)
    ahead = torch.arange(T + 1, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
    states = torch.empty((n_steps + 1, 4), dtype=torch.float32, device=dev)
    controls = torch.empty((n_steps, 2), dtype=torch.float32, device=dev)
    states[0] = x
    for k in range(n_steps):
        i0 = torch.argmin(torch.sum((ref[:, :2] - x[:2]) ** 2, dim=1))
        x_ref = ref[torch.clamp(i0 + ahead, 0, ref.shape[0] - 1)]
        u0 = _solve(cfg, x, x_ref, x[2], x_ref[0, 3], zero)[0]
        a, d = torch.clamp(u0, lo, hi).unbind()
        xx, yy, v, yaw = x.unbind()
        x = torch.stack([xx + v * torch.cos(yaw) * dt, yy + v * torch.sin(yaw) * dt,
                         v + a * dt, yaw + v / L * torch.tan(d) * dt])
        states[k + 1] = x
        controls[k] = u0
    return states.cpu().numpy(), controls.cpu().numpy()


def sine_road_demo(n_steps: int = 120, device="cuda"):
    """The reference demo's scenario: a sine-shaped road tracked from rest
    with a 1 m lateral offset (JAX :182).  → (reference, states, controls)."""
    cfg = LinearMPCConfig()
    s = np.linspace(0, 60, 600)
    xr, yr = s, 2.0 * np.sin(s / 6.0)
    yaw = np.arctan2(np.gradient(yr), np.gradient(xr))
    reference = np.column_stack([xr, yr, np.full_like(s, 3.0), yaw])
    x0 = np.array([0.0, -1.0, 0.0, 0.0])
    states, controls = simulate_tracking(cfg, reference, x0, n_steps, device=device)
    return reference, states, controls
