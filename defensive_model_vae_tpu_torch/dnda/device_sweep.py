"""The DNDA collision sweep as one batched torch program (SAT + first hit +
surrounding-vehicle prediction).

Port of ``defensive_model_vae_tpu/dnda/device_sweep.py``: the per-frame host
code of :mod:`.collision` (reference ``Generate_surVehicle_Traj`` /
``Collison_Detection``, ``dnda_functions.py:1343-1616``) as tensor ops over
(frames × paths × ego points × vehicles × 4 axes), batched over the frame
axis explicitly.  JAX computes it in plain XLA, with no Pallas kernel, so
here it is plain torch on tensors of an explicit device (the card by
default), with no kernel of its own and no ``torch.compile``.

All frames are padded on the host to bucketed shapes (:func:`pad_frames`:
paths and vehicles to multiples of 8, points to a multiple of 128, frames to
whole 256-frame chunks) and swept one chunk at a time, each chunk copied from
pinned memory without blocking; the indices come back once at the end
(:func:`sweep_padded`).

Precision, as in JAX's ``jax.enable_x64`` scope: the vehicle prediction and
the ceil-based first-hit window bookkeeping run in float64, in the numpy
oracle's order of evaluation (``((speed·j)·dt)/u``, left to right); only the
SAT geometry runs in ``sat_dtype``.  Every product and sum is its own op, so
none is contracted into an FMA.  Both SAT dtypes are held index-identical to
the numpy oracle (``tests/test_torch_dnda.py``, ``chip_smoke.py``'s ``dnda``
phase).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .._device import resolve_device

_CHUNK = 256  # frames swept at once (JAX ``device_sweep.py:193``)


def _predict_rects(sur: torch.Tensor, t: torch.Tensor):
    """(F, V, 9) float64 vehicle rows → the corner components (rx0..rx3,
    ry0..ry3), each (F, V, T+1), in float64.

    ``collision.predict_surrounding_rectangles`` batched: the stop-on-reversal
    freeze, the ``arctan(vy/vx)`` heading (not atan2), the stationary case
    ``heading + 1.57`` and the per-branch freeze of the heading."""
    x0, y0, length, width = sur[..., 0], sur[..., 1], sur[..., 2], sur[..., 3]
    sx, sy, ax, ay, hdg = sur[..., 4], sur[..., 5], sur[..., 6], sur[..., 7], sur[..., 8]
    sx, sy, ax, ay = sx[..., None], sy[..., None], ax[..., None], ay[..., None]

    vx = sx + ax * t  # (F, V, T+1)
    vy = sy + ay * t
    sp2 = vx * vx + vy * vy
    dots = vx[..., :-1] * vx[..., 1:] + vy[..., :-1] * vy[..., 1:]
    stop_at = torch.cat(
        [torch.zeros_like(sp2[..., :1], dtype=torch.bool), (dots <= 0) | (sp2[..., 1:] == 0)],
        dim=-1,
    )
    any_stop = stop_at.any(dim=-1)
    # first stop step (>= 1 when any); argmax has no CUDA kernel for bool
    j_stop = torch.argmax(stop_at.to(torch.int32), dim=-1)
    idx = torch.arange(t.shape[0], device=t.device)
    frozen = any_stop[..., None] & (idx >= j_stop[..., None])
    t_freeze = t[(j_stop - 1).clamp(min=0)]  # (F, V)
    t_eff = torch.where(frozen, t_freeze[..., None], t)

    x = x0[..., None] + sx * t_eff + 0.5 * ax * (t_eff * t_eff)
    y = y0[..., None] + sy * t_eff + 0.5 * ay * (t_eff * t_eff)

    vx_safe = torch.where(vx == 0, 1.0, vx)
    theta_free = torch.where(vx == 0, 1.5708, torch.atan(vy / vx_safe))
    theta_free[..., 0] = torch.where(sp2[..., 0] == 0, hdg + 1.57, theta_free[..., 0])
    # per-branch freeze (see collision.predict_surrounding_rectangles: the
    # reference's vx == 0 branch assigns 1.5708 even on frozen steps):
    # forward-fill theta from the last "set" step
    override = (vx == 0) & (sp2 != 0)
    set_mask = ~frozen | override
    set_mask[..., 0] = True
    fill = torch.cummax(torch.where(set_mask, idx, -1), dim=-1).values
    theta = torch.gather(theta_free, -1, fill)

    half_l, half_w = (length / 2)[..., None], (width / 2)[..., None]
    base_x = (half_l, -half_l, -half_l, half_l)
    base_y = (-half_w, -half_w, half_w, half_w)
    c, s = torch.cos(theta), torch.sin(theta)
    # R @ base + pos per component, the numpy einsum's a·b + c·d order:
    # rx = c·bx + (−s)·by + x, ry = s·bx + c·by + y
    rx = tuple(c * bx + -s * by + x for bx, by in zip(base_x, base_y))
    ry = tuple(s * bx + c * by + y for bx, by in zip(base_x, base_y))
    return rx + ry


def _sat_components(a_xy, b_xy) -> torch.Tensor:
    """Separating-axis overlap test, the arithmetic of
    ``collision.sat_collision`` (reference ``:1526-1616``) over corner
    component tensors (x0..x3, y0..y3) of the two sides, which broadcast
    against each other → the boolean overlap tensor."""
    ax, ay = a_xy
    bx, by = b_xy
    # edge vectors (the reference's check axes): a1, a2, b1, b2
    axes = (
        (ax[1] - ax[0], ay[1] - ay[0]),
        (ax[2] - ax[1], ay[2] - ay[1]),
        (bx[1] - bx[0], by[1] - by[0]),
        (bx[2] - bx[1], by[2] - by[1]),
    )
    # half-edge vectors of the projection radius (0.5 · check)
    halves = [(0.5 * ex, 0.5 * ey) for ex, ey in axes]

    cvx = (bx[1] + bx[3]) / 2 - (ax[1] + ax[3]) / 2
    cvy = (by[1] + by[3]) / 2 - (ay[1] + ay[3]) / 2

    separated = None
    for ex, ey in axes:
        norm = torch.sqrt(ex * ex + ey * ey)
        safe = torch.where(norm == 0, 1.0, norm)
        ux, uy = ex / safe, ey / safe  # a division, as the numpy oracle's
        radius = None
        for hx, hy in halves:
            term = torch.abs(ux * hx + uy * hy)
            radius = term if radius is None else radius + term
        sep = torch.abs(ux * cvx + uy * cvy) > radius
        separated = sep if separated is None else separated | sep
    return ~separated


def _sweep_chunk(ego, arcs, spd, sur, vmask, npts, *, n_time: int, time_step: float,
                 time_horizon: float, sat_dtype: torch.dtype) -> torch.Tensor:
    """One chunk of frames → (F, P) first-hit collision indices, mirroring
    ``collision.collision_indices`` (reference scan ``:1491-1524``).

    ego (F, 2, 4, P, N) in ``sat_dtype`` (xy × corner × path × point); arcs
    (F, P), spd (F,) and sur (F, V, 9) float64; vmask (F, V) bool; npts (F, P)
    int32."""
    F, P, N = ego.shape[0], ego.shape[3], ego.shape[4]
    V = sur.shape[1]
    dev = ego.device
    t = torch.arange(n_time + 1, dtype=torch.float64, device=dev) * time_step
    sur_comp = _predict_rects(sur, t)  # 8 × (F, V, T+1)

    # the oracle's order: ceil(speed * j * dt / u)
    jgrid = torch.arange(n_time + 1, dtype=torch.float64, device=dev)
    bounds = torch.ceil(spd[:, None, None] * jgrid * time_step / arcs[:, :, None])  # (F, P, T+1)
    n_idx = torch.arange(N, device=dev)
    # (F, P, N): the last j with bounds[j] <= n
    j_of_n = (n_idx[:, None] >= bounds[:, :, None, :]).sum(dim=-1) - 1
    # points past a path's real length do not exist in the host scan
    checked = ((j_of_n >= 0) & (j_of_n < n_time) & (n_idx < bounds[:, :, -1:])
               & (n_idx < npts[:, :, None]))
    j_clip = j_of_n.clamp(0, n_time)
    bj = torch.gather(bounds, 2, j_clip)
    in_window = checked & (n_idx >= bj)

    # each point's vehicle corners at its step: (F, V, P, N) per component
    jc = j_clip.reshape(F, 1, P * N).expand(F, V, P * N)
    sur_c = [torch.gather(rc, 2, jc).reshape(F, V, P, N).to(sat_dtype) for rc in sur_comp]
    ego_c = [ego[:, xy, k, None] for xy in range(2) for k in range(4)]  # (F, 1, P, N)
    hit_v = _sat_components((ego_c[:4], ego_c[4:]), (sur_c[:4], sur_c[4:]))
    hits = (hit_v & vmask[:, :, None, None]).any(dim=1) & in_window  # (F, P, N)

    any_hit = hits.any(dim=-1)
    first = torch.argmax(hits.to(torch.int32), dim=-1)
    default = torch.ceil(spd[:, None] * time_horizon / arcs).to(torch.int64)
    return torch.where(any_hit, first - 1, default)


@dataclasses.dataclass
class PaddedFrames:
    """The host arrays of a sweep, padded to bucketed shapes (pinned when the
    sweep goes to the card).  ``n_paths[f]`` paths of frame f are real."""

    ego: torch.Tensor  # (F, 2, 4, P, N) sat dtype
    arcs: torch.Tensor  # (F, P) float64, padding 1.0
    spd: torch.Tensor  # (F,) float64
    sur: torch.Tensor  # (F, V, 9) float64
    vmask: torch.Tensor  # (F, V) bool
    npts: torch.Tensor  # (F, P) int32
    n_paths: List[int]
    time_horizon: float
    time_step: float


def _up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def pad_frames(
    ego_rects_per_frame: Sequence[List[np.ndarray]],
    unit_arcs_per_frame: Sequence[Sequence[float]],
    speeds: Sequence[float],
    sur_per_frame: Sequence[np.ndarray],
    time_horizon: float,
    time_step: float,
    sat_dtype: str = "float32",
    pin: bool = False,
) -> PaddedFrames:
    """Pad many frames' sweeps to one bucketed shape on the host (JAX
    ``sweep_frames_device`` :243-315): the last rectangle replicated into a
    path's padding keeps the SAT arithmetic finite (the points are masked
    anyway), padded arcs are 1.0, and a zero-point path keeps all-zero
    corners that ``npts`` masks out, so it returns the no-collision default
    as the host oracle does."""
    F0 = len(ego_rects_per_frame)
    P = max(max((len(r) for r in ego_rects_per_frame), default=1), 1)
    N = max(max((e.shape[0] for rects in ego_rects_per_frame for e in rects), default=1), 1)
    V = max(max((np.atleast_2d(s).shape[0] if np.asarray(s).size else 0
                 for s in sur_per_frame), default=1), 1)
    P, V, N = _up(P, 8), _up(V, 8), _up(N, 128)
    F = _up(max(F0, 1), _CHUNK)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, pin_memory=pin)

    ego_t = zeros((F, 2, 4, P, N), getattr(torch, sat_dtype))
    arcs_t = zeros((F, P), torch.float64)
    spd_t = zeros((F,), torch.float64)
    sur_t = zeros((F, V, 9), torch.float64)
    vmask_t = zeros((F, V), torch.bool)
    npts_t = zeros((F, P), torch.int32)
    ego, arcs, spd = ego_t.numpy(), arcs_t.numpy(), spd_t.numpy()
    sur, vmask, npts = sur_t.numpy(), vmask_t.numpy(), npts_t.numpy()
    arcs[:] = 1.0  # keeps the padding's divisions finite
    spd[:F0] = np.asarray(speeds, float)
    for f in range(F0):
        for p, r in enumerate(ego_rects_per_frame[f]):
            # (n, 2, 4) → (2, 4, n), cast to the SAT dtype on the host
            n = r.shape[0]
            rt = np.transpose(r, (1, 2, 0))
            ego[f, :, :, p, :n] = rt
            npts[f, p] = n
            if 0 < n < N:
                ego[f, :, :, p, n:] = rt[:, :, -1:]
        arcs[f, : len(unit_arcs_per_frame[f])] = np.asarray(unit_arcs_per_frame[f], float)
        s = np.atleast_2d(np.asarray(sur_per_frame[f], float))
        if s.size:
            sur[f, : s.shape[0]] = s
            vmask[f, : s.shape[0]] = True
    return PaddedFrames(ego_t, arcs_t, spd_t, sur_t, vmask_t, npts_t,
                        [len(r) for r in ego_rects_per_frame], time_horizon, time_step)


def sweep_padded(padded: PaddedFrames, device="cuda") -> List[np.ndarray]:
    """Sweep padded frames on ``device``, one 256-frame chunk at a time →
    per frame, its (P_f,) int collision indices."""
    dev = resolve_device(device)
    n_time = int(padded.time_horizon / padded.time_step)
    host = (padded.ego, padded.arcs, padded.spd, padded.sur, padded.vmask, padded.npts)
    outs = []
    with torch.inference_mode():
        for k in range(0, padded.ego.shape[0], _CHUNK):
            chunk = [a[k: k + _CHUNK].to(dev, non_blocking=True) for a in host]
            outs.append(_sweep_chunk(*chunk, n_time=n_time, time_step=padded.time_step,
                                     time_horizon=padded.time_horizon,
                                     sat_dtype=padded.ego.dtype))
        ci = torch.cat(outs).cpu().numpy()
    return [ci[f, :n].astype(int) for f, n in enumerate(padded.n_paths)]


def sweep_frames_device(
    ego_rects_per_frame: Sequence[List[np.ndarray]],
    unit_arcs_per_frame: Sequence[Sequence[float]],
    speeds: Sequence[float],
    sur_per_frame: Sequence[np.ndarray],
    time_horizon: float,
    time_step: float,
    sat_dtype: str = "float32",
    device="cuda",
) -> List[np.ndarray]:
    """The SAT collision sweep of many frames in one batched program on
    ``device``.

    Args:
        ego_rects_per_frame: per frame, a list over usable paths of (N_i, 2, 4)
            rectangle sweeps.
        unit_arcs_per_frame: per frame, the paths' uniform arc steps.
        speeds: per-frame ego speed.
        sur_per_frame: per frame, (V_f, 9) surrounding-vehicle rows in the
            frame's rotated coordinates (may be empty).

    Returns: per frame, (P_f,) int collision indices, identical to
    ``collision.collision_indices`` run frame by frame.
    """
    dev = resolve_device(device)
    if not ego_rects_per_frame:
        return []
    padded = pad_frames(ego_rects_per_frame, unit_arcs_per_frame, speeds, sur_per_frame,
                        time_horizon, time_step, sat_dtype, pin=dev.type == "cuda")
    return sweep_padded(padded, dev)
