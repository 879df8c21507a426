"""Batched MPC path tracker — projected Levenberg–Marquardt in torch.

Port of ``defensive_model_vae_tpu/control/mpc.py``: the same cost (track
[theta, v] with Q = diag(20, 5), Qf = Q, control-increment penalty
R = diag(1, 50), control hold beyond the control horizon, box bounds
|a| ≤ 7 and |δ| ≤ 0.5) written as a residual vector, solved by projected
LM with a fixed iteration count (:141-186), with the first-solve Δu
exemption (:114-132), inside the outer simulation over timesteps
(:189-222) whose length is rounded up to a multiple of 64 (:298).

Where the JAX package ``vmap``s one trajectory's program, every tensor here
carries the batch as its first dimension, so the number of launches does
not grow with the batch.  The Jacobian is not ``jacfwd``: the forward
sensitivities ∂state/∂u are carried through the same explicit-Euler
recurrence that computes the states.  In the bicycle model θ and v — the
tracked states — do not depend on x and y, and the recurrence for them and
for their sensitivities is a running sum over the horizon, so one LM
iteration is one pass of prefix sums over the 30 steps (``torch.cumsum``),
not 30 Python-level steps.

JAX runs the outer simulation as one jitted ``lax.scan``; here a step is
one function in place on static buffers.  On the CPU it is :func:`_step`,
the torch ops above, run as a Python loop (:func:`_simulate_eager`).  On a
CUDA device it is :func:`_kernel_step`: each LM iteration three hand-written
launches (``ops/mpc_step.py``'s form kernel, the LU kernel, its update
kernel), 9 a step, captured once per (config, batch size, device) as a
CUDA graph and replayed once a step.  The LM systems are solved by
``ops/lu_solve.py``, the port's own kernel: ``torch.linalg.solve_ex``
reaches MAGMA's batched LU from some batch on, which a capture cannot
take.  :func:`_simulate_eager` is the kernels' plain version; the kernels
sum in other orders, so the two agree to float32 rounding, not bit for
bit.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import mpc_step
from ..ops.lu_solve import lu_solve
from ..utils.profiling import span
from .reference import PathReference


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    # defaults = reference tracking runs (mpc.py:38-60)
    prediction_horizon: int = 30
    control_horizon: int = 20
    dt: float = 0.02
    wheelbase: float = 2.8
    max_steer: float = 0.5
    max_accel: float = 7.0
    q: Tuple[float, float] = (20.0, 5.0)
    qf: Tuple[float, float] = (20.0, 5.0)
    r: Tuple[float, float] = (1.0, 50.0)
    lm_iters: int = 3
    lm_lambda: float = 1e-3
    # Gauss-Newton with the Jacobian evaluated once per step at the warm start
    freeze_jacobian: bool = False
    raw_jump_guard: bool = False

    def __post_init__(self):
        if self.control_horizon > self.prediction_horizon:
            raise ValueError(
                "control_horizon must be <= prediction_horizon "
                f"({self.control_horizon} > {self.prediction_horizon})"
            )


def _clip_deriv(u: torch.Tensor, bound: float) -> torch.Tensor:
    """d clip(u, -bound, bound)/du as JAX differentiates ``jnp.clip``:
    1 inside, 1/2 on the bound, 0 outside."""
    a = u.abs()
    return torch.where(a < bound, 1.0, torch.where(a == bound, 0.5, 0.0))


def _dynamics(cfg: MPCConfig, state: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """Kinematic bicycle [x, y, theta, v]' with clipped [a, delta]
    (mpc.py:80); batched over leading dimensions."""
    x, y, theta, v = state.unbind(-1)
    a = torch.clamp(control[..., 0], -cfg.max_accel, cfg.max_accel)
    delta = torch.clamp(control[..., 1], -cfg.max_steer, cfg.max_steer)
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta),
                        v * torch.tan(delta) / cfg.wheelbase, a], dim=-1)


def _theta_v(cfg: MPCConfig, state0: torch.Tensor, controls: torch.Tensor):
    """θ and v over an Euler rollout, (B, N+1) each, and the clipped inputs.
    v_{t+1} = v_t + a_t dt and θ_{t+1} = θ_t + v_t tan(δ_t)/L dt are prefix
    sums, since neither depends on x or y."""
    a = torch.clamp(controls[..., 0], -cfg.max_accel, cfg.max_accel)
    tan_d = torch.tan(torch.clamp(controls[..., 1], -cfg.max_steer, cfg.max_steer))
    v0, th0 = state0[:, 3:4], state0[:, 2:3]
    v = torch.cat([v0, v0 + torch.cumsum(a * cfg.dt, dim=1)], dim=1)
    dth = v[:, :-1] * tan_d / cfg.wheelbase * cfg.dt
    th = torch.cat([th0, th0 + torch.cumsum(dth, dim=1)], dim=1)
    return th, v, tan_d


def rollout(cfg: MPCConfig, state0: torch.Tensor, controls: torch.Tensor) -> torch.Tensor:
    """Explicit-Euler rollout (mpc.py:98): (B, 4), (B, N, 2) → (B, N+1, 4);
    also (4,), (N, 2) → (N+1, 4)."""
    single = state0.ndim == 1
    if single:
        state0, controls = state0[None], controls[None]
    th, v, _ = _theta_v(cfg, state0, controls)
    vx = v[:, :-1] * torch.cos(th[:, :-1]) * cfg.dt
    vy = v[:, :-1] * torch.sin(th[:, :-1]) * cfg.dt
    x = torch.cat([state0[:, 0:1], state0[:, 0:1] + torch.cumsum(vx, dim=1)], dim=1)
    y = torch.cat([state0[:, 1:2], state0[:, 1:2] + torch.cumsum(vy, dim=1)], dim=1)
    out = torch.stack([x, y, th, v], dim=-1)
    return out[0] if single else out


class _Problem:
    """The constant pieces of one configuration's LM problem, on a device
    (built once per (cfg, device) by :func:`_problem`)."""

    def __init__(self, cfg: MPCConfig, dev: torch.device):
        P, M = cfg.prediction_horizon, cfg.control_horizon
        f32 = dict(dtype=torch.float32, device=dev)
        self.cfg, self.P, self.M = cfg, P, M
        self.consts = mpc_step.Consts.of(cfg)
        sq = torch.tensor(cfg.q, **f32).sqrt()
        sqf = torch.tensor(cfg.qf, **f32).sqrt()
        self.w_track = torch.cat([sq.expand(P, 2), sqf[None]], dim=0)  # (P+1, 2)
        self.sqrt_r = torch.tensor(cfg.r, **f32).sqrt()
        # per-step input s drives control row min(s, M-1) (the hold)
        hold = torch.zeros((P, M), **f32)
        hold[torch.arange(P), torch.clamp(torch.arange(P), max=M - 1)] = 1.0
        self.hold = hold
        t = torch.arange(P + 1, device=dev)[:, None]
        s = torch.arange(P, device=dev)[None, :]
        self.before = (s < t).to(torch.float32)  # (P+1, P): input s moves state t
        self.lo = torch.tensor([-cfg.max_accel, -cfg.max_steer], **f32)
        self.hi = -self.lo
        self.eye = torch.eye(2 * M, **f32)
        # Δu rows: d du_res[i, c] / d u[j, c] = sqrt(r_c) w_i ([i = j] - [j = i-1])
        diff = torch.eye(M, **f32) - torch.eye(M, **f32).roll(-1, dims=1).tril()
        self.du_jac = {}
        for w0 in (0.0, 1.0):
            du_w = torch.ones(M, **f32)
            du_w[0] = w0
            jd = (du_w[:, None, None, None] * diff[:, None, :, None]
                  * torch.diag(self.sqrt_r)[None, :, None, :])  # (M, 2, M, 2)
            self.du_jac[w0] = (jd.reshape(2 * M, 2 * M), du_w)

    def full_controls(self, u: torch.Tensor) -> torch.Tensor:
        """(B, M, 2) → (B, P, 2) holding the last input (mpc.py:110)."""
        if self.P == self.M:
            return u
        return torch.cat([u, u[:, -1:].expand(-1, self.P - self.M, -1)], dim=1)

    def du_pair(self, first: torch.Tensor):
        """The Δu rows' (Jacobian, weights) pair of the step: the Δu₀-free
        pair where the 0-d bool ``first`` is set.  A select between the two
        pairs built above, so no arithmetic differs from the pair looked up
        by its weight, and the flag can live on the device."""
        (j0, w0), (j1, w1) = self.du_jac[0.0], self.du_jac[1.0]
        return torch.where(first, j0, j1), torch.where(first, w0, w1)

    def residuals(self, u, state, ref, last, du, jac: bool):
        """Residual vector (B, R) whose sum of squares is the cost
        (mpc.py:114), and with ``jac`` its Jacobian (B, R, 2M); ``du`` the
        Δu rows' (Jacobian, weights) pair (``du_jac[du0_w]`` or
        :meth:`du_pair`)."""
        cfg, P, M = self.cfg, self.P, self.M
        B = u.shape[0]
        uf = self.full_controls(u)
        th, v, tan_d = _theta_v(cfg, state, uf)
        track = (torch.stack([th, v], dim=-1) - ref) * self.w_track  # (B, P+1, 2)
        du_jac, du_w = du
        prev = torch.cat([last[:, None], u[:, :-1]], dim=1)
        du = (u - prev) * self.sqrt_r * du_w[:, None]
        res = torch.cat([track.reshape(B, -1), du.reshape(B, -1)], dim=1)
        if not jac:
            return res, None
        dt, L = cfg.dt, cfg.wheelbase
        ca = _clip_deriv(uf[..., 0], cfg.max_accel)  # (B, P)
        cd = _clip_deriv(uf[..., 1], cfg.max_steer)
        # ∂v_t/∂a_s = dt·ca_s·[s < t]
        dv_da = dt * ca[:, None, :] * self.before
        # ∂θ_t/∂a_s = dt·ca_s·Σ_{s<r<t} tan δ_r/L·dt
        kk = torch.cat([torch.zeros_like(tan_d[:, :1]),
                        torch.cumsum(tan_d / L * dt, dim=1)], dim=1)  # (B, P+1)
        dth_da = dv_da * (kk[:, :, None] - kk[:, None, 1:])
        # ∂θ_t/∂δ_s = v_s·sec²δ_s·cd_s/L·dt·[s < t]
        dth_dd = ((v[:, :-1] * (1.0 + tan_d * tan_d) * cd / L * dt)[:, None, :]
                  * self.before)
        J = torch.zeros((B, P + 1, 2, M, 2), dtype=res.dtype, device=res.device)
        J[:, :, 0, :, 0] = (dth_da @ self.hold) * self.w_track[None, :, 0:1]
        J[:, :, 0, :, 1] = (dth_dd @ self.hold) * self.w_track[None, :, 0:1]
        J[:, :, 1, :, 0] = (dv_da @ self.hold) * self.w_track[None, :, 1:2]
        J = torch.cat([J.reshape(B, 2 * (P + 1), 2 * M),
                       du_jac.expand(B, -1, -1)], dim=1)
        return res, J

    def solve(self, state, ref, last, u_init, first):
        """Projected LM with a fixed iteration count (mpc.py:141); ``first``
        the 0-d bool flag of a simulation's first solve (:func:`_step`)."""
        cfg, M = self.cfg, self.M
        B = u_init.shape[0]
        du = self.du_pair(first)
        u = u_init
        lam = torch.full((B,), cfg.lm_lambda, dtype=torch.float32, device=u.device)
        J0 = None
        if cfg.freeze_jacobian:
            _, J0 = self.residuals(u_init, state, ref, last, du, True)
        for _ in range(cfg.lm_iters):
            r, J = self.residuals(u, state, ref, last, du, J0 is None)
            if J0 is not None:
                J = J0
            Jt = J.transpose(1, 2)
            Hm = Jt @ J + lam[:, None, None] * self.eye
            g = Jt @ r[:, :, None]
            step = -lu_solve(Hm, g)[:, :, 0]
            u_trial = torch.minimum(torch.maximum(
                u + step.reshape(B, M, 2), self.lo), self.hi)
            cost0 = torch.sum(r * r, dim=1)
            r1, _ = self.residuals(u_trial, state, ref, last, du, False)
            accept = torch.sum(r1 * r1, dim=1) < cost0
            u = torch.where(accept[:, None, None], u_trial, u)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return u


@functools.lru_cache(maxsize=32)
def _problem(cfg: MPCConfig, dev: torch.device) -> _Problem:
    """One configuration's constant pieces on a device, built once."""
    return _Problem(cfg, dev)


class _StepBuffers:
    """What one simulation step reads and writes, in place: the state
    (B, 4), the last applied control (B, 2), the step's reference rows
    (B, P+1, 2), the warm start (B, M, 2) and the first-solve flag (a 0-d
    bool).  The captured graph's static buffers, and the eager loop's."""

    def __init__(self, cfg: MPCConfig, B: int, dev: torch.device):
        f32 = dict(dtype=torch.float32, device=dev)
        self.state = torch.zeros((B, 4), **f32)
        self.last = torch.zeros((B, 2), **f32)
        self.ref = torch.zeros((B, cfg.prediction_horizon + 1, 2), **f32)
        self.u0 = torch.zeros((B, cfg.control_horizon, 2), **f32)
        self.first = torch.zeros((), dtype=torch.bool, device=dev)

    def start(self, states0: torch.Tensor, last0: torch.Tensor) -> None:
        self.state.copy_(states0)
        self.last.copy_(last0)
        self.u0.zero_()
        self.first.fill_(True)


def _step(prob: _Problem, buf: _StepBuffers) -> None:
    """One step of the simulation (mpc.py:196, the scan's body), in place on ``buf``:
    solve warm-started with the applied control, apply the solve's first
    control, Euler-step.  Δu₀ is free on the first solve of a simulation
    (mpc.py:121-126): the flag selects that pair and the step clears it."""
    cfg = prob.cfg
    buf.u0[:, 0] = buf.last
    u = prob.solve(buf.state, buf.ref, buf.last, buf.u0, buf.first)
    last = u[:, 0]
    buf.state.copy_(buf.state + _dynamics(cfg, buf.state, last) * cfg.dt)
    buf.last.copy_(last)
    buf.first.fill_(False)


class _KernelBuffers:
    """What :func:`_kernel_step` reads and writes, in place: the state, the
    last applied control and the step's reference rows (as
    :class:`_StepBuffers`), the warm start [last, 0, …] (B, M, 2) that the
    LM iterations update, each row's first-solve flag (B,) int32 (each
    row's block clears its own), λ, the cost at the iterate and the LM
    system H (B, 2M, 2M), g (B, 2M, 1).  The captured graph's static
    buffers."""

    def __init__(self, cfg: MPCConfig, B: int, dev: torch.device):
        P, M = cfg.prediction_horizon, cfg.control_horizon
        f32 = dict(dtype=torch.float32, device=dev)
        self.state = torch.zeros((B, 4), **f32)
        self.last = torch.zeros((B, 2), **f32)
        self.ref = torch.zeros((B, P + 1, 2), **f32)
        self.u = torch.zeros((B, M, 2), **f32)
        self.first = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.lam = torch.zeros((B,), **f32)
        self.cost0 = torch.zeros((B,), **f32)
        self.H = torch.zeros((B, 2 * M, 2 * M), **f32)
        self.g = torch.zeros((B, 2 * M, 1), **f32)

    def start(self, states0: torch.Tensor, last0: torch.Tensor) -> None:
        self.state.copy_(states0)
        self.last.copy_(last0)
        self.u.zero_()
        self.u[:, 0] = last0
        self.first.fill_(1)


def _kernel_step(prob: _Problem, buf: _KernelBuffers) -> None:
    """:func:`_step` as the kernels run it, in place on ``buf``: each LM
    iteration the form kernel (H, g, the cost), the LU kernel and the
    update kernel, whose last applies the solve's first control."""
    cfg, k = prob.cfg, prob.consts
    for it in range(cfg.lm_iters):
        mpc_step.form(buf.u, buf.state, buf.ref, buf.last, buf.first, buf.lam, buf.H, buf.g,
                      buf.cost0, k, it, cfg.freeze_jacobian)
        x = lu_solve(buf.H, buf.g)
        mpc_step.update(x, buf.u, buf.state, buf.ref, buf.last, buf.first, buf.lam,
                        buf.cost0, k, it, it == cfg.lm_iters - 1)


def _check_kernel_cfg(cfg: MPCConfig) -> None:
    """Raise where the kernel step does not take ``cfg``."""
    mpc_step.check_bounds(cfg.prediction_horizon, cfg.control_horizon)
    if cfg.lm_iters < 1:
        raise ValueError(f"the kernel step runs 1 or more LM iterations, got {cfg.lm_iters}")


def _loop(step, prob, buf, states0, refs, last0):
    """:func:`_simulate` as a Python loop of ``step`` on ``buf``."""
    dev = states0.device
    B, S = refs.shape[0], refs.shape[1]
    buf.start(states0, last0)
    states = torch.empty((B, S + 1, 4), dtype=torch.float32, device=dev)
    controls = torch.empty((B, S, 2), dtype=torch.float32, device=dev)
    states[:, 0] = states0
    for i in range(S):
        buf.ref.copy_(refs[:, i])
        step(prob, buf)
        states[:, i + 1] = buf.state
        controls[:, i] = buf.last
    return states, controls


def _simulate_eager(cfg: MPCConfig, states0: torch.Tensor, refs: torch.Tensor,
                    last0: torch.Tensor):
    """:func:`_simulate` as a Python loop over :func:`_step`, the torch ops:
    the CPU's path, and the kernels' plain version on the card."""
    dev = states0.device
    return _loop(_step, _problem(cfg, dev), _StepBuffers(cfg, refs.shape[0], dev),
                 states0, refs, last0)


def _simulate_kernels(cfg: MPCConfig, states0: torch.Tensor, refs: torch.Tensor,
                      last0: torch.Tensor):
    """:func:`_simulate` as a Python loop over :func:`_kernel_step`: on the
    card the kernels launched without a capture (the captured graph's
    bits), on the CPU their plain mirror."""
    _check_kernel_cfg(cfg)
    dev = states0.device
    return _loop(_kernel_step, _problem(cfg, dev), _KernelBuffers(cfg, refs.shape[0], dev),
                 states0, refs, last0)


# the captured steps, keyed by (cfg, B, device), least recently used first;
# each graph holds its static buffers and a private memory pool, which an
# eviction releases with the last reference to it
GRAPH_CACHE_MAX = 16
_graphs: "collections.OrderedDict" = collections.OrderedDict()
# one lock over the cache, the captures, the replays and the counts: each
# key is captured once, no two threads write one graph's buffers, and the
# counts are exact
_lock = threading.Lock()
# each device's captures run on a stream of their own
_capture_streams = {}
# captures since import (a replay of a cached graph adds none), and the
# steps replayed
graph_captures = 0
graph_steps = 0


class _StepGraph:
    """:func:`_kernel_step` at one batch size captured as one CUDA graph."""

    def __init__(self, cfg: MPCConfig, B: int, dev: torch.device):
        prob = _problem(cfg, dev)
        self.buf = _KernelBuffers(cfg, B, dev)
        self.graph = torch.cuda.CUDAGraph()
        stream = _capture_streams.get(dev)
        if stream is None:
            stream = _capture_streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # one eager step first, on the capture stream: the kernels'
            # libraries are built and loaded, and a fault shows, outside
            # the capture
            _kernel_step(prob, self.buf)
            # thread_local: another thread's CUDA calls (the server's
            # caller, a rank sharing the card) neither fail this capture
            # nor are failed by it
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                _kernel_step(prob, self.buf)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)


def _step_graph(cfg: MPCConfig, B: int, dev: torch.device) -> _StepGraph:
    """The cached graph of (cfg, B, dev), captured on its first use (the
    caller holds ``_lock``)."""
    global graph_captures
    key = (cfg, B, dev)
    g = _graphs.get(key)
    if g is None:
        try:
            with span("mpc.capture"):
                g = _StepGraph(cfg, B, dev)
        except Exception as e:
            raise RuntimeError(f"capturing the tracker step at batch {B} on {dev} failed: "
                               f"{type(e).__name__}: {e}") from e
        graph_captures += 1
        _graphs[key] = g
        while len(_graphs) > GRAPH_CACHE_MAX:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    return g


def _simulate_captured(cfg: MPCConfig, states0: torch.Tensor, refs: torch.Tensor,
                       last0: torch.Tensor):
    """:func:`_simulate` on a CUDA device: the kernel step captured once per
    batch size (:class:`_StepGraph`) and replayed S times.  A step's host
    work is one copy of its reference rows in, the replay, and two copies
    out."""
    global graph_steps
    _check_kernel_cfg(cfg)
    dev = states0.device
    B, S = refs.shape[0], refs.shape[1]
    states = torch.empty((B, S + 1, 4), dtype=torch.float32, device=dev)
    controls = torch.empty((B, S, 2), dtype=torch.float32, device=dev)
    states[:, 0] = states0
    # the graph's buffers are written inside inference mode only, whatever
    # mode the caller runs in (the serve program runs in it)
    with torch.inference_mode(), _lock:
        g = _step_graph(cfg, B, dev)
        buf = g.buf
        buf.start(states0, last0)
        try:
            with span("mpc.replays", device=dev):
                for i in range(S):
                    buf.ref.copy_(refs[:, i])
                    g.graph.replay()
                    states[:, i + 1] = buf.state
                    controls[:, i] = buf.last
        except Exception as e:
            raise RuntimeError(f"replaying the tracker step at batch {B} on {dev} "
                               f"failed: {type(e).__name__}: {e}") from e
        graph_steps += S
    return states, controls


def _simulate(cfg: MPCConfig, states0: torch.Tensor, refs: torch.Tensor,
              last0: torch.Tensor):
    """Track B paths: refs (B, S, P+1, 2) → states (B, S+1, 4), controls
    (B, S, 2) (mpc.py:189).  Solve, apply the first control, Euler-step;
    the next solve is warm-started with the applied control.  On a CUDA
    device the kernel step runs as one captured CUDA graph replayed S
    times, and a shape past the kernels' bounds or a failed capture or
    replay raises; elsewhere the eager loop of torch ops runs."""
    if states0.device.type == "cuda":
        return _simulate_captured(cfg, states0, refs, last0)
    return _simulate_eager(cfg, states0, refs, last0)


def _initial_tracker_state(initial_state: np.ndarray) -> np.ndarray:
    """[x, y, theta, vx, vy] → [x, y, theta, |v|] with the −2.8 rad wrap
    (mpc.py:237)."""
    s = np.asarray(initial_state, float).copy()
    if s[2] < -2.8:
        s[2] += 2 * np.pi
    return np.array([s[0], s[1], s[2], float(np.hypot(s[3], s[4]))])


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev)


def track(waypoints: np.ndarray, initial_state: np.ndarray,
          cfg: MPCConfig = MPCConfig(), total_time=None, device="cuda"):
    """Track one waypoint path (mpc.py:248).  → (times, states (N+1, 4),
    controls (N, 2)) as numpy."""
    dev = resolve_device(device)
    ref = PathReference(np.asarray(waypoints, float), np.asarray(initial_state, float),
                        raw_jump_guard=cfg.raw_jump_guard)
    if total_time is None:
        total_time = float(waypoints[-1, 2])
    num_steps = int(total_time / cfg.dt)
    refs = ref.build(num_steps, cfg.prediction_horizon, cfg.dt)
    state0 = _initial_tracker_state(initial_state)
    states, controls = _simulate(cfg, _f32(state0[None], dev), _f32(refs[None], dev),
                                 torch.zeros((1, 2), device=dev))
    times = np.arange(num_steps + 1) * cfg.dt
    return times, states[0].cpu().numpy(), controls[0].cpu().numpy()


def track_batch(waypoints_batch: np.ndarray, initial_states: np.ndarray,
                cfg: MPCConfig = MPCConfig(), device="cuda", mesh=None):
    """Track B waypoint paths at once (mpc.py:258).

    ``mesh`` (``parallel.create_mesh``; the run is on its device) splits the
    paths over its data axis: each rank tracks its block of rows (padded
    with copies of row 0) and the blocks are gathered to every rank.

    Returns (times (S+1,), states (B, S+1, 4), controls (B, S, 2), steps
    (B,)) with S the longest path's step count rounded up to a multiple of
    64; rows past ``steps[b]`` extrapolate beyond path b's end."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh

        check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    B = waypoints_batch.shape[0]
    steps = np.array([int(float(w[-1, 2]) / cfg.dt) for w in waypoints_batch],
                     dtype=np.int64)
    S = -(-int(steps.max()) // 64) * 64
    rows = np.arange(B)
    if mesh is not None:
        from ..parallel.mesh import shard_batch

        rows = shard_batch(rows, mesh)
    refs = np.stack([PathReference(np.asarray(waypoints_batch[b], float),
                                   np.asarray(initial_states[b], float),
                                   raw_jump_guard=cfg.raw_jump_guard)
                     .build(S, cfg.prediction_horizon, cfg.dt) for b in rows])
    states0 = np.stack([_initial_tracker_state(initial_states[b]) for b in rows])
    states, controls = _simulate(cfg, _f32(states0, dev), _f32(refs, dev),
                                 torch.zeros((len(rows), 2), device=dev))
    if mesh is not None:
        from ..parallel.mesh import gather_rows

        states, controls = gather_rows(states, mesh)[:B], gather_rows(controls, mesh)[:B]
    times = np.arange(S + 1) * cfg.dt
    return times, states.cpu().numpy(), controls.cpu().numpy(), steps
