"""Device-side reference construction — the serving program.

Port of ``defensive_model_vae_tpu/control/device_reference.py``.  The host
``control.reference.PathReference`` builds the MPC reference with scipy;
for serving, this module builds the same reference in torch on the device,
so that

    decode(z, c) → waypoints → reference tensor → MPC simulation

runs as one sequence of device work with no host round trip (see
:func:`make_serve_fn`).  Where JAX ``vmap``s one path, the batch is the
leading dimension of every tensor here.

The cubic interpolant is scipy ``interp1d(kind='cubic')``'s not-a-knot C²
cubic: its second derivatives solve a small dense system with not-a-knot
end conditions, one (n, n) system a path, solved as one batch by
``torch.linalg.solve_ex`` (JAX calls ``jnp.linalg.solve`` outside any
Pallas kernel; ``solve_ex`` skips the per-call info check, which would
synchronise with the host).  The reference heuristics are replicated: the
knot-difference velocity spline seeded with the initial velocity, the
−2.8 rad wrap, the 45° end-velocity scan (a fixed 1 ms grid over
``scan_seconds``, masked past the path's end), the 90° jump guard with the
wrapped semantics, constant-velocity extrapolation, and the per-window
low-speed heading hold.  Requires ≥ 4 waypoints (the cubic regime; the
generated paths have 10).

**The request's draws.** JAX derives each row's z from
``split(PRNGKey(seed), B)`` and then ``_N_DRAWS`` subkeys a row; torch has
no threefry, so the port keeps the contract with a scheme of its own.
Candidate k of row b is row ``b·_N_DRAWS + k`` of
``ops.fused_trainer.philox_normal_on(seed, 0, rows, Z)``: Philox4x32-10
keyed by the 64-bit seed with counter (0, b·_N_DRAWS + k, c // 4, 0) and
Box–Muller over 24-bit uniforms, drawn on the device.  A row's draws so
depend only on (seed, row index): the padding rows a server adds never
change a real row.  ``z=`` feeds explicit (B, _N_DRAWS, Z) draws instead
(the tests pass the z the JAX side drew).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_WRAP_LIMIT = -2.8
_SCAN_DT = 1e-3
# The 45° end-velocity scan needs a static grid on the device (the host
# twin scans arange(0, t_end + 1e-3), data-dependent); the window is
# `scan_seconds` (default 20 s; decoded trajectories run ~11 s), masked to
# t_end.  Jumps past the window are invisible: raise `scan_seconds` in
# build_reference_device if paths can be longer.

_N_DRAWS = 8  # z candidates a serve request (the degenerate-sample redraw)


def _wrap(theta: torch.Tensor) -> torch.Tensor:
    return torch.where(theta >= _WRAP_LIMIT, theta, theta + 2 * math.pi)


def notaknot_coeffs(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Second derivatives M (B, n) of the not-a-knot C² cubics through
    (t, y), each (B, n) (JAX :47).

    Interior rows: h_{i-1}/6 M_{i-1} + (h_{i-1}+h_i)/3 M_i + h_i/6 M_{i+1}
    = Δslope_i; the end rows hold the third derivative continuous at the
    first and last interior knots."""
    B, n = t.shape
    h = torch.diff(t, dim=1)
    slope = torch.diff(y, dim=1) / h
    A = torch.zeros((B, n, n), dtype=t.dtype, device=t.device)
    b = torch.zeros((B, n), dtype=t.dtype, device=t.device)
    i = torch.arange(1, n - 1, device=t.device)
    A[:, i, i - 1] = h[:, :-1] / 6.0
    A[:, i, i] = (h[:, :-1] + h[:, 1:]) / 3.0
    A[:, i, i + 1] = h[:, 1:] / 6.0
    b[:, 1:n - 1] = slope[:, 1:] - slope[:, :-1]
    # not-a-knot: (M1 − M0)/h0 = (M2 − M1)/h1, and mirrored at the end
    A[:, 0, 0] = 1.0 / h[:, 0]
    A[:, 0, 1] = -(1.0 / h[:, 0] + 1.0 / h[:, 1])
    A[:, 0, 2] = 1.0 / h[:, 1]
    A[:, n - 1, n - 3] = 1.0 / h[:, n - 3]
    A[:, n - 1, n - 2] = -(1.0 / h[:, n - 3] + 1.0 / h[:, n - 2])
    A[:, n - 1, n - 1] = 1.0 / h[:, n - 2]
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def cubic_eval(t: torch.Tensor, y: torch.Tensor, M: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """The C² cubics (B, n) at queries q (B, Q), extrapolating with the end
    cubics (JAX :77)."""
    n = t.shape[1]
    idx = torch.clamp(torch.searchsorted(t.contiguous(), q.contiguous(), right=True) - 1,
                      0, n - 2)
    t0, t1 = t.gather(1, idx), t.gather(1, idx + 1)
    h = t1 - t0
    a = (t1 - q) / h
    bfrac = (q - t0) / h
    return (a * y.gather(1, idx) + bfrac * y.gather(1, idx + 1)
            + ((a ** 3 - a) * M.gather(1, idx) + (bfrac ** 3 - bfrac) * M.gather(1, idx + 1))
            * h ** 2 / 6.0)


def build_reference_device(waypoints: torch.Tensor, initial_state: torch.Tensor,
                           num_steps: int, horizon: int, dt: float,
                           scan_seconds: float = 20.0) -> torch.Tensor:
    """Torch twin of ``PathReference.build`` for B paths at once (JAX :91):
    → (B, num_steps, horizon+1, 2) [θ_ref, v_ref].

    Args:
        waypoints: (B, N, 3) [x, y, t] rows, t strictly increasing, N ≥ 4.
        initial_state: (B, 5) [x, y, θ, vx, vy].
        scan_seconds: the length of the 45° heading scan's static window;
            it must cover the longest path's duration.
    """
    dev = waypoints.device
    f32 = dict(dtype=torch.float32, device=dev)
    B = waypoints.shape[0]
    t, x, y = waypoints[..., 2], waypoints[..., 0], waypoints[..., 1]
    t_end = t[:, -1:]

    # the [θ, v] reference needs only the velocity splines: knots at the
    # midpoints of the data's differences, seeded with the initial velocity
    dtk = torch.diff(t, dim=1)
    h = torch.where(dtk == 0, 1e-6, dtk)
    vx_k = torch.cat([initial_state[:, 3:4], torch.diff(x, dim=1) / h], dim=1)
    vy_k = torch.cat([initial_state[:, 4:5], torch.diff(y, dim=1) / h], dim=1)
    t_vel = torch.cat([torch.zeros((B, 1), **f32), t[:, :-1] + dtk / 2], dim=1)
    Mvx = notaknot_coeffs(t_vel, vx_k)
    Mvy = notaknot_coeffs(t_vel, vy_k)

    def v_at(q):
        return cubic_eval(t_vel, vx_k, Mvx, q), cubic_eval(t_vel, vy_k, Mvy, q)

    start_vx, start_vy = v_at(t[:, :1])
    start_theta = _wrap(torch.atan2(start_vy, start_vx))  # (B, 1)

    # end velocity: the first heading jump over 45° on the 1 ms grid
    n_scan = int(round(scan_seconds / _SCAN_DT)) + 1
    scan_t = (torch.arange(n_scan, **f32) * _SCAN_DT)[None].expand(B, -1)
    in_range = scan_t <= t_end + _SCAN_DT  # the reference grid includes t_end
    svx, svy = v_at(scan_t)
    th_scan = _wrap(torch.atan2(svy, svx))
    jumped = ((th_scan - start_theta).abs() > math.radians(45.0)) & in_range
    any_jump = jumped.any(dim=1, keepdim=True)
    mid_vx, mid_vy = v_at((t[:, -1:] + t[:, -2:-1]) / 2)
    end_vx_plain, end_vy_plain = v_at(t_end)
    end_vx = torch.where(any_jump, mid_vx, end_vx_plain)
    end_vy = torch.where(any_jump, mid_vy, end_vy_plain)
    end_theta = _wrap(torch.atan2(end_vy, end_vx))

    # reference values over the whole clock grid
    grid_t = (torch.arange(num_steps + horizon + 1, **f32) * dt)[None].expand(B, -1)
    inside = grid_t <= t_end
    vx_g, vy_g = v_at(torch.where(inside, grid_t, t_end))
    vx_g = torch.where(inside, vx_g, end_vx)
    vy_g = torch.where(inside, vy_g, end_vy)
    # the 90° jump guard with the published artifacts' (wrapped) semantics
    # (PathReference.raw_jump_guard's docstring)
    theta_g = _wrap(torch.atan2(vy_g, vx_g))
    jump = inside & ((theta_g - start_theta).abs() > math.pi / 2)
    vx_g = torch.where(jump, end_vx, vx_g)
    vy_g = torch.where(jump, end_vy, vy_g)
    v_g = torch.hypot(vx_g, vy_g)
    theta_g = _wrap(torch.atan2(vy_g, vx_g))
    theta_g = torch.where(grid_t > t_end, end_theta, theta_g)

    # windows and the low-speed heading hold: each column takes the heading
    # of the last column at or before it with v ≥ 0.1, and 0 where none is
    # (JAX's lax.scan forward fill from a zero carry)
    idx = (torch.arange(num_steps, device=dev)[:, None]
           + torch.arange(horizon + 1, device=dev)[None, :]).reshape(-1)
    v_win = v_g[:, idx].reshape(B, num_steps, horizon + 1)
    th_win = theta_g[:, idx].reshape(B, num_steps, horizon + 1)
    col = torch.arange(horizon + 1, device=dev).expand_as(v_win)
    last = torch.cummax(torch.where(v_win >= 0.1, col, -1), dim=-1).values
    th_held = torch.where(last >= 0, th_win.gather(-1, last.clamp(min=0)), 0.0)
    return torch.stack([th_held, v_win], dim=-1)


def select_valid_trajectory(trajs: torch.Tensor) -> torch.Tensor:
    """The first of K candidate decodes a row whose time column, with t₀
    set to 0, strictly increases; candidate 0 with its time column
    repaired (running max + a 1 ms ramp) where none does (JAX :183).

    The device twin of the host redraw loop: serving cannot drop a
    request, and a non-monotone time column would make the not-a-knot
    system singular.  The repair is the identity for a valid draw.

    Args:
        trajs: (B, K, T, 3) candidate [t, x, y] decodes.

    Returns:
        (B, T, 3) with a strictly increasing, zero-based time column.
    """
    B, K, T = trajs.shape[:3]
    t0z = trajs[..., 0].clone()
    t0z[:, :, 0] = 0.0
    ok = (torch.diff(t0z, dim=-1) > 0).all(dim=-1)           # (B, K)
    pick = torch.argmax(ok.to(torch.int32), dim=1)          # first True; 0 if none
    rows = torch.arange(B, device=trajs.device)
    traj = trajs[rows, pick]                                # (B, T, 3)
    t = t0z[rows, pick]
    repaired = (torch.cummax(t, dim=-1).values
                + torch.arange(T, dtype=t.dtype, device=t.device) * 1e-3)
    t = torch.where(ok.any(dim=1, keepdim=True), t, repaired)
    return torch.stack([t, traj[..., 1], traj[..., 2]], dim=-1)


def request_draws(seed: int, rows: int, per_row: int, latent_dim: int,
                  device) -> torch.Tensor:
    """(rows, per_row, Z) N(0, 1) draws: draw k of row b is counter row
    b·per_row + k of the seed's Philox stream (module docstring)."""
    from ..ops.fused_trainer import philox_normal_on

    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    z = philox_normal_on(seed, 0, rows * per_row, latent_dim, device)
    return z.reshape(rows, per_row, latent_dim)


def _as_f32(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev)


def make_serve_fn(params, model_cfg, mpc_cfg, num_steps: int,
                  offset_mode: bool = True, mesh=None):
    """condition → sample → reference → MPC as one device program (JAX
    :214), on the device the params live on.

    Returns ``serve(seed, start_xy, initial_states, z=None) → (states (B,
    S+1, 4), controls (B, S, 2))`` as device tensors, with ``start_xy``
    (B, 2), ``initial_states`` (B, 5) [x, y, θ, vx, vy] and S =
    ``num_steps``.  Each row decodes ``_N_DRAWS`` candidates (module
    docstring for the draws; ``z`` (B, _N_DRAWS, Z) feeds them
    explicitly), keeps the first valid one, builds its reference and
    tracks it; all rows share one batched simulation.

    ``offset_mode=False`` serves legacy non-offset checkpoints, whose
    decoder emits absolute [t, x, y] that must not be shifted by the start
    point (as ``generate.load_and_generate`` reads the manifest).

    ``mesh`` (``parallel.create_mesh``, the params on its device) splits the
    request batch over the data axis (JAX :278-289): every rank draws the
    whole batch's z, runs its block of rows, and the blocks are gathered to
    every rank, so the result is the one-device program's.  B must be a
    multiple of the data-axis size.  A block that fails on any rank fails
    the call on every rank before the gather (``parallel.mesh.run_block``),
    so the group stays in step for the next call."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh

        check_mesh(mesh)
    if getattr(mpc_cfg, "raw_jump_guard", False):
        # the device reference implements only the wrapped jump guard; a
        # raw-guard config would serve other trajectories than track()
        raise ValueError(
            "make_serve_fn implements the wrapped jump-guard only; "
            "raw_jump_guard=True (the in-tree differential-test variant) "
            "is host-path-only — use control.track/track_batch")
    from ..models import sample
    from .mpc import _simulate

    dev = params["dec_3"]["w"].device
    P = mpc_cfg.prediction_horizon

    def serve(seed, start_xy, initial_states, z: Optional[torch.Tensor] = None):
        if mesh is None:
            return _serve_batch(seed, start_xy, initial_states, z)
        from ..parallel.mesh import gather_rows, run_block

        states, controls = run_block(
            lambda: _serve_batch(seed, start_xy, initial_states, z), mesh)
        return gather_rows(states, mesh), gather_rows(controls, mesh)

    def _serve_batch(seed, start_xy, initial_states, z):
        """The batch's rows (with a mesh, this rank's block of them)."""
        starts = _as_f32(start_xy, dev)
        inits = _as_f32(initial_states, dev)
        B = starts.shape[0]
        if z is None:
            z = request_draws(seed, B, _N_DRAWS, model_cfg.latent_dim, dev)
        z = _as_f32(z, dev)
        if tuple(z.shape) != (B, _N_DRAWS, model_cfg.latent_dim):
            raise ValueError(f"z has shape {tuple(z.shape)}; expected "
                             f"({B}, {_N_DRAWS}, {model_cfg.latent_dim})")
        if mesh is None:
            return _serve_rows(starts, inits, z)
        from ..parallel.mesh import block

        if B % mesh.shape["data"]:
            raise ValueError(f"batch {B} is not a multiple of the "
                             f"{mesh.shape['data']}-rank data axis")
        rows = block(B, mesh)
        return _serve_rows(starts[rows], inits[rows], z[rows])

    def _serve_rows(starts, inits, z):
        B = starts.shape[0]
        with torch.inference_mode():
            trajs = sample(params, None, starts.repeat_interleave(_N_DRAWS, dim=0),
                           model_cfg, z=z.reshape(B * _N_DRAWS, -1),
                           shift_start=offset_mode)
            traj = select_valid_trajectory(
                trajs.reshape(B, _N_DRAWS, model_cfg.seq_len, model_cfg.dim))
            wp = torch.stack([traj[..., 1], traj[..., 2], traj[..., 0]], dim=-1)
            refs = build_reference_device(wp, inits, num_steps, P, mpc_cfg.dt)
            # [x, y, θ, |v|] with the −2.8 rad wrap (_initial_tracker_state)
            theta = inits[:, 2]
            theta = torch.where(theta < -2.8, theta + 2 * math.pi, theta)
            state0 = torch.stack([inits[:, 0], inits[:, 1], theta,
                                  torch.hypot(inits[:, 3], inits[:, 4])], dim=1)
            return _simulate(mpc_cfg, state0, refs,
                             torch.zeros((B, 2), dtype=torch.float32, device=dev))

    return serve
