"""The ``/serve`` program, plain PyTorch: decode candidates, keep the first
valid one a row, build its [θ, v] reference, track it with the nonlinear
MPC.  Float32 throughout, on the caller's device.

What a request is (the serve contract of the repo's JAX server):

- z: candidate k of row b is row b·8 + k of the request seed's standard
  normals, Philox4x32-10 keyed by the 64-bit seed (low word, high word)
  with counter (0, row, column // 4, 0), words (0, 1) and (2, 3) turned into
  two Box–Muller pairs over 24-bit uniforms, u₁ = ((w >> 8) + 1)·2⁻²⁴,
  u₂ = (w >> 8)·2⁻²⁴, giving r·cos, r·sin for columns 4k … 4k+3;
- decode [z, condition(start)] through the checkpoint's decoder, shifted
  by the start point in x and y;
- the first candidate whose time column (its first value set to 0)
  strictly increases; candidate 0 with the time column repaired (running
  maximum plus a 1 ms ramp) where none does;
- the reference: not-a-knot cubic splines of the velocity (knots at the
  waypoints' time midpoints, seeded with the initial velocity at t = 0),
  the start heading, the end velocity (at the midpoint of the last two
  waypoints' times if the heading leaves the start heading by more than
  45° anywhere on a 1 ms grid up to the end, else at the end), headings
  wrapped from −2.8 rad, the 90° jump guard, constant values past the end,
  and each horizon's low-speed heading hold (a column with v < 0.1 takes
  the heading of the last column at or before it with v ≥ 0.1, 0 where
  none);
- the tracker: a kinematic bicycle (wheelbase 2.8 m, |a| ≤ 7, |δ| ≤ 0.5),
  per step three projected Levenberg–Marquardt iterations over the first
  M = 20 inputs (held to P = 30), cost Σ q·(θ, v − reference)² + r·Δu²
  with Δu₀ free on the first step, λ halved on an accepted step and
  quadrupled on a rejected one (within [1e-8, 1e4]), warm-started with
  the applied input then zeros; the first input applied, an Euler step.

The Jacobian is written out from the prefix sums (:func:`jacobian`),
with a clip whose derivative is 1 inside the bounds, ½ on them and 0
outside (the convention the serve contract inherits from JAX's ``clip``);
a test holds it to autograd's of :func:`batched_residuals`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_DRAWS = 8
WRAP = -2.8
WHEELBASE, MAX_STEER, MAX_ACCEL = 2.8, 0.5, 7.0
Q, QF, R = (20.0, 5.0), (20.0, 5.0), (1.0, 50.0)
LM_LAMBDA = 1e-3
SCAN_DT, SCAN_S = 1e-3, 20.0
_U32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


# ---- the request's draws ------------------------------------------------------

def philox_normals(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    groups = (cols + 3) // 4
    row = np.repeat(np.arange(rows, dtype=np.uint64), groups)
    grp = np.tile(np.arange(groups, dtype=np.uint64), rows)
    c = [np.zeros_like(row), row, grp, np.zeros_like(row)]
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W[0]) & _U32, (k1 + _W[1]) & _U32
        p0 = np.uint64(_M[0]) * c[0]
        p1 = np.uint64(_M[1]) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & np.uint64(_U32),
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & np.uint64(_U32)]
    w = [torch.as_tensor(a.astype(np.int64)).to(device) for a in c]
    out = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1 = ((a >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))
        u2 = (b >> 8).to(torch.float32) * (1.0 / (1 << 24))
        rad = torch.sqrt(-2.0 * torch.log(u1))
        out += [rad * torch.cos(2.0 * math.pi * u2), rad * torch.sin(2.0 * math.pi * u2)]
    return torch.stack(out, dim=1).reshape(rows, groups * 4)[:, :cols]


# ---- decode and select --------------------------------------------------------

def decode(params: dict, z: torch.Tensor, start: torch.Tensor, seq_len: int, dim: int):
    lin = lambda n, h: h @ params[n + "/w"] + params[n + "/b"]  # noqa: E731
    hc = torch.relu(lin("cond_1", torch.relu(lin("cond_0", start))))
    h = torch.cat([z, hc], dim=1)
    for n in ("dec_0", "dec_1", "dec_2"):
        h = torch.relu(lin(n, h))
    out = lin("dec_3", h).reshape(-1, seq_len, dim).clone()
    out[:, :, 1:3] += start[:, None, :]
    return out


def select(trajs: torch.Tensor) -> torch.Tensor:
    """(B, K, T, 3) candidates → (B, T, 3) with a zero-based time column."""
    B, K, T = trajs.shape[:3]
    t = trajs[..., 0].clone()
    t[:, :, 0] = 0.0
    ok = (t[:, :, 1:] > t[:, :, :-1]).all(dim=-1)
    out = []
    for b in range(B):
        good = torch.nonzero(ok[b]).flatten()
        k = int(good[0]) if len(good) else 0
        tb = t[b, k]
        if not len(good):
            tb = torch.cummax(tb, dim=0).values + torch.arange(T, device=t.device) * 1e-3
        out.append(torch.stack([tb, trajs[b, k, :, 1], trajs[b, k, :, 2]], dim=-1))
    return torch.stack(out)


# ---- the reference path -------------------------------------------------------

def spline_m(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Second derivatives of the not-a-knot cubic spline through (t, y)."""
    n = t.shape[0]
    h = t[1:] - t[:-1]
    s = (y[1:] - y[:-1]) / h
    A = torch.zeros((n, n), dtype=t.dtype, device=t.device)
    rhs = torch.zeros(n, dtype=t.dtype, device=t.device)
    for i in range(1, n - 1):
        A[i, i - 1], A[i, i], A[i, i + 1] = h[i - 1] / 6, (h[i - 1] + h[i]) / 3, h[i] / 6
        rhs[i] = s[i] - s[i - 1]
    A[0, 0], A[0, 1], A[0, 2] = 1 / h[0], -(1 / h[0] + 1 / h[1]), 1 / h[1]
    A[n - 1, n - 3], A[n - 1, n - 2], A[n - 1, n - 1] = \
        1 / h[n - 3], -(1 / h[n - 3] + 1 / h[n - 2]), 1 / h[n - 2]
    return torch.linalg.solve(A, rhs)


def spline_at(t, y, m, q):
    """The spline at queries q, the end pieces extended beyond the knots."""
    n = t.shape[0]
    i = torch.clamp(torch.searchsorted(t, q, right=True) - 1, 0, n - 2)
    h = t[i + 1] - t[i]
    a, b = (t[i + 1] - q) / h, (q - t[i]) / h
    return a * y[i] + b * y[i + 1] + ((a ** 3 - a) * m[i] + (b ** 3 - b) * m[i + 1]) * h * h / 6


def wrap(th):
    return torch.where(th >= WRAP, th, th + 2 * math.pi)


def path_reference(wp: torch.Tensor, init: torch.Tensor, steps: int, P: int, dt: float):
    """One path's (steps, P+1, 2) [θ, v] reference; wp (T, 3) [x, y, t],
    init [x, y, θ, vx, vy]."""
    dev, f32 = wp.device, torch.float32
    x, y, t = wp[:, 0], wp[:, 1], wp[:, 2]
    dtk = t[1:] - t[:-1]
    dtk = torch.where(dtk == 0, torch.full_like(dtk, 1e-6), dtk)
    knots = torch.cat([torch.zeros(1, device=dev), t[:-1] + (t[1:] - t[:-1]) / 2])
    vxk = torch.cat([init[3:4], (x[1:] - x[:-1]) / dtk])
    vyk = torch.cat([init[4:5], (y[1:] - y[:-1]) / dtk])
    mx, my = spline_m(knots, vxk), spline_m(knots, vyk)
    vel = lambda q: (spline_at(knots, vxk, mx, q), spline_at(knots, vyk, my, q))  # noqa: E731
    t_end = t[-1]
    svx, svy = vel(t[:1])
    th0 = wrap(torch.atan2(svy, svx))[0]
    grid = torch.arange(int(round(SCAN_S / SCAN_DT)) + 1, device=dev, dtype=f32) * SCAN_DT
    gx, gy = vel(grid)
    turned = ((wrap(torch.atan2(gy, gx)) - th0).abs() > math.radians(45.0)) \
        & (grid <= t_end + SCAN_DT)
    q_end = (t[-1] + t[-2]) / 2 if bool(turned.any()) else t_end
    evx, evy = vel(q_end.reshape(1))
    th_end = wrap(torch.atan2(evy, evx))[0]
    clock = torch.arange(steps + P + 1, device=dev, dtype=f32) * dt
    inside = clock <= t_end
    cvx, cvy = vel(torch.where(inside, clock, t_end))
    cvx, cvy = torch.where(inside, cvx, evx), torch.where(inside, cvy, evy)
    jump = inside & ((wrap(torch.atan2(cvy, cvx)) - th0).abs() > math.pi / 2)
    cvx, cvy = torch.where(jump, evx, cvx), torch.where(jump, evy, cvy)
    v = torch.hypot(cvx, cvy)
    th = torch.where(clock > t_end, th_end, wrap(torch.atan2(cvy, cvx)))
    idx = torch.arange(steps, device=dev)[:, None] + torch.arange(P + 1, device=dev)[None]
    vw, thw = v[idx], th[idx]
    held = torch.zeros_like(thw)
    last = torch.zeros_like(thw[:, 0])
    seen = torch.zeros_like(vw[:, 0], dtype=torch.bool)
    for j in range(P + 1):  # each column: the heading of the last fast one so far
        fast = vw[:, j] >= 0.1
        last = torch.where(fast, thw[:, j], last)
        seen = seen | fast
        held[:, j] = torch.where(seen, last, torch.zeros_like(last))
    return torch.stack([held, vw], dim=-1)


# ---- the tracker --------------------------------------------------------------

def clip(u, bound: float):
    """clip(u, ±bound) whose derivative is 1 inside, ½ on the bound, 0 outside."""
    hard = torch.where(u.abs() < bound, u, torch.sign(u) * bound)
    return 0.5 * (torch.clamp(u, -bound, bound) + hard)


def clip_slope(u, bound: float):
    return torch.where(u.abs() < bound, 1.0, torch.where(u.abs() == bound, 0.5, 0.0))


def batched_residuals(u, state, ref, last, first: bool, P: int, M: int, dt: float):
    """Every row's residual vector, (B, 2(P+1) + 2M): the weighted [θ, v]
    tracking errors over the horizon, then the weighted input changes (Δu₀
    free on a simulation's first solve).  Its sum of squares is the cost."""
    uf = torch.cat([u, u[:, -1:].expand(-1, P - M, -1)], dim=1) if P > M else u
    a, d = clip(uf[..., 0], MAX_ACCEL), clip(uf[..., 1], MAX_STEER)
    v = torch.cat([state[:, 3:4], state[:, 3:4] + torch.cumsum(a * dt, 1)], dim=1)
    th = torch.cat([state[:, 2:3], state[:, 2:3]
                    + torch.cumsum(v[:, :-1] * torch.tan(d) / WHEELBASE * dt, 1)], dim=1)
    w = torch.tensor([Q] * P + [QF], dtype=u.dtype, device=u.device).sqrt()
    track = (torch.stack([th, v], dim=-1) - ref) * w
    prev = torch.cat([last[:, None], u[:, :-1]], dim=1)
    du = (u - prev) * torch.tensor(R, dtype=u.dtype, device=u.device).sqrt()
    if first:
        du = torch.cat([torch.zeros_like(du[:, :1]), du[:, 1:]], dim=1)
    return torch.cat([track.reshape(u.shape[0], -1), du.reshape(u.shape[0], -1)], dim=1)


def jacobian(u, state, first: bool, P: int, M: int, dt: float):
    """d residuals / d u, (B, 2(P+1) + 2M, 2M), columns (input j, channel c)
    at 2j + c.  With H[s, j] = 1 where step s holds input j and S[t, s] = 1
    for s < t: ∂v_t/∂a_j = dt·a'_j·(S H)[t, j]; ∂θ_t/∂a_j = dt/L·Σ_{s<t}
    tan δ_s ∂v_s/∂a_j; ∂θ_t/∂δ_j = dt/L·δ'_j·Σ_{s<t} v_s sec² δ_s H[s, j]."""
    B, dev, f32 = u.shape[0], u.device, u.dtype
    uf = torch.cat([u, u[:, -1:].expand(-1, P - M, -1)], dim=1) if P > M else u
    a, d = clip(uf[..., 0], MAX_ACCEL), clip(uf[..., 1], MAX_STEER)
    v = torch.cat([state[:, 3:4], state[:, 3:4] + torch.cumsum(a * dt, 1)], dim=1)
    H = torch.zeros((P, M), dtype=f32, device=dev)
    H[torch.arange(P), torch.clamp(torch.arange(P), max=M - 1)] = 1.0
    S = torch.tril(torch.ones((P + 1, P), dtype=f32, device=dev), diagonal=-1)
    sa = clip_slope(u[..., 0], MAX_ACCEL)                              # (B, M)
    sd = clip_slope(u[..., 1], MAX_STEER)
    dv_da = dt * (S @ H)[None] * sa[:, None, :]                       # (B, P+1, M)
    tan_d = torch.tan(d)
    dth_da = dt / WHEELBASE * (S[None] * tan_d[:, None, :]) @ dv_da[:, :P]
    dth_dd = (dt / WHEELBASE * (S[None] * (v[:, :P] * (1 + tan_d ** 2))[:, None, :]) @ H
              * sd[:, None, :])
    w = torch.tensor([Q] * P + [QF], dtype=f32, device=dev).sqrt()     # (P+1, 2)
    J = torch.zeros((B, P + 1, 2, M, 2), dtype=f32, device=dev)
    J[:, :, 0, :, 0] = dth_da * w[None, :, 0:1]
    J[:, :, 0, :, 1] = dth_dd * w[None, :, 0:1]
    J[:, :, 1, :, 0] = dv_da * w[None, :, 1:2]
    Jdu = torch.zeros((M, 2, M, 2), dtype=f32, device=dev)
    sr = torch.tensor(R, dtype=f32, device=dev).sqrt()
    for i in range(M):
        if i == 0 and first:
            continue
        for c in range(2):
            Jdu[i, c, i, c] = sr[c]
            if i > 0:
                Jdu[i, c, i - 1, c] = -sr[c]
    return torch.cat([J.reshape(B, 2 * (P + 1), 2 * M),
                      Jdu.reshape(2 * M, 2 * M).expand(B, -1, -1)], dim=1)


def solve(state, ref, last, u, first: bool, P: int, M: int, dt: float, iters: int):
    """Projected LM with a fixed number of iterations, all rows at once."""
    B = u.shape[0]
    lam = torch.full((B,), LM_LAMBDA, dtype=u.dtype, device=u.device)
    eye = torch.eye(2 * M, dtype=u.dtype, device=u.device)
    lo = torch.tensor([-MAX_ACCEL, -MAX_STEER], dtype=u.dtype, device=u.device)
    for _ in range(iters):
        r = batched_residuals(u, state, ref, last, first, P, M, dt)
        J = jacobian(u, state, first, P, M, dt)
        H = J.transpose(1, 2) @ J + lam[:, None, None] * eye
        g = J.transpose(1, 2) @ r[:, :, None]
        step = -torch.linalg.solve(H, g)[:, :, 0]
        trial = torch.minimum(torch.maximum(u + step.reshape(B, M, 2), lo), -lo)
        r1 = batched_residuals(trial, state, ref, last, first, P, M, dt)
        accept = (r1 * r1).sum(1) < (r * r).sum(1)
        u = torch.where(accept[:, None, None], trial, u)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return u


def track(state0, refs, P: int, M: int, dt: float, iters: int):
    """(B, 4) states, (B, S, P+1, 2) references → states (B, S+1, 4),
    controls (B, S, 2)."""
    B, S = refs.shape[:2]
    state = state0.clone()
    last = torch.zeros((B, 2), dtype=state.dtype, device=state.device)
    states, controls = [state], []
    for i in range(S):
        u0 = torch.zeros((B, M, 2), dtype=state.dtype, device=state.device)
        u0[:, 0] = last
        u = solve(state, refs[:, i], last, u0, i == 0, P, M, dt, iters)
        last = u[:, 0]
        a, d = clip(last[:, 0], MAX_ACCEL), clip(last[:, 1], MAX_STEER)
        x, y, th, v = state.unbind(-1)
        state = state + torch.stack([v * torch.cos(th), v * torch.sin(th),
                                     v * torch.tan(d) / WHEELBASE, a], dim=-1) * dt
        states.append(state)
        controls.append(last)
    return torch.stack(states, dim=1), torch.stack(controls, dim=1)


def serve(params: dict, seed: int, starts, inits, steps: int, dt: float, cfg: dict):
    """One request's (states, controls) on the params' device."""
    dev = params["dec_3/w"].device
    starts = torch.as_tensor(np.asarray(starts, np.float32)).to(dev)
    inits = torch.as_tensor(np.asarray(inits, np.float32)).to(dev)
    B, T, D, Z = starts.shape[0], cfg["seq_len"], cfg["dim"], cfg["latent_dim"]
    z = philox_normals(int(seed), B * N_DRAWS, Z, dev)
    trajs = decode(params, z, starts.repeat_interleave(N_DRAWS, dim=0), T, D)
    traj = select(trajs.reshape(B, N_DRAWS, T, D))
    P, M = cfg["tracker"]["prediction_horizon"], cfg["tracker"]["control_horizon"]
    refs = torch.stack([path_reference(torch.stack([traj[b, :, 1], traj[b, :, 2],
                                                    traj[b, :, 0]], dim=-1),
                                       inits[b], steps, P, dt) for b in range(B)])
    th = torch.where(inits[:, 2] < WRAP, inits[:, 2] + 2 * math.pi, inits[:, 2])
    state0 = torch.stack([inits[:, 0], inits[:, 1], th, torch.hypot(inits[:, 3], inits[:, 4])],
                         dim=1)
    return track(state0, refs, P, M, dt, cfg["tracker"]["lm_iters"])


def load_params(ckpt_dir: str, device) -> dict:
    """A checkpoint's ``params.npz`` ("layer/leaf" arrays) as float32 tensors."""
    with np.load(f"{ckpt_dir}/params.npz") as z:
        return {k: torch.as_tensor(z[k].astype(np.float32)).to(device) for k in z.files}
