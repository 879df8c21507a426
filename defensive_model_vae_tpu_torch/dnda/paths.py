"""Ego candidate-path cluster generation (reference
``Generate_Ego_TraCluster`` / ``generate_path`` / ``addPath``,
``dnda_functions.py:913-1339``).

For each of ``traj_num`` lateral end offsets, fit a cubic lateral-offset
profile q(s) = a·s³ + b·s² + c·s + d in the reference path's Frenet frame
(q(0)=init_q, q'(0)=tan(rel θ), q(sf)=qf, q'(sf)=0), map to Cartesian via
the path normal, and iteratively lengthen any path whose max curvature
exceeds k_max.  Each accepted path is resampled at uniform arc length
(101 points) and swept with the ego rectangle.

The data-dependent lengthening loop stays on the host (bounded, tiny); the
per-path geometry inside each round is vectorized.

Port of ``defensive_model_vae_tpu/dnda/paths.py``, the arithmetic unchanged
(its order is load-bearing: see :func:`_cubic_lateral_profile`).  The
curvature checks and the resample run in the native spline library, which
has no fallback; a path the native code rejects goes through the numpy
version, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .frenet import Way, cartesian_to_frenet, curvature_theta, _rotation
from .geometry import Road, Vehicle
from .spline import (
    fmm_spline_coeffs,
    frenet_batch_native,
    max_curvature_batch_native,
    max_curvature_native,
    spline_eval,
)


def _cubic_lateral_profile(ego: Vehicle, cdnt_arc, seg_end: int, qf: float):
    """Solve for (a, b) of q(s) with the four boundary conditions.

    ``inv(A) @ B`` — NOT ``solve`` — mirrors the reference's exact
    arithmetic (``dnda_functions.py:963``): the two differ bitwise on
    ~84% of these 2×2 systems (measured), and a ~1-ulp drift in (a, b)
    can flip the curvature-lengthening threshold on a boundary frame.
    The NaN→0 sanitization is the reference's own (``:965-971``); the
    LinAlgError catch is a robustness fix (exactly-singular A would crash
    the reference uncaught)."""
    d = ego.init_q
    c = math.tan(ego.relative_theta)
    L = cdnt_arc[seg_end] - cdnt_arc[0]
    A = np.array([[L**3, L**2], [3 * L**2, 2 * L]])
    B = np.array([qf - d - c * L, -c])
    try:
        ab = np.linalg.inv(A) @ B
    except np.linalg.LinAlgError:
        ab = np.zeros(2)
    a, b = (0.0 if np.isnan(v) else float(v) for v in ab)
    return a, b, c, d


def _cubic_lateral_profiles(ego: Vehicle, cdnt_arc, seg_ends, qfs):
    """Per-path :func:`_cubic_lateral_profile` calls (a cluster has ~14
    paths of 2×2 systems — microseconds; a stacked LAPACK dispatch would
    round differently than the reference's per-path ``inv(A) @ B``)."""
    return [
        _cubic_lateral_profile(ego, cdnt_arc, s, q)
        for s, q in zip(seg_ends, qfs)
    ]


def _path_xy(way: Way, cdnt_arc, seg_end: int, a, b, c, d):
    """Evaluate one candidate path over grid indices 0..seg_end."""
    s = cdnt_arc[: seg_end + 1] - cdnt_arc[0]
    q = a * s**3 + b * s**2 + c * s + d
    x = way.baseline_x[: seg_end + 1] - q * way.d1y[: seg_end + 1]
    y = way.baseline_y[: seg_end + 1] + q * way.d1x[: seg_end + 1]
    return x, y


def _paths_xy_full(way: Way, cdnt_arc, profs):
    """Full-grid K-path variant of :func:`_path_xy`: (K, m+1) x/y arrays
    whose row slices ``[: seg+1]`` are bit-identical to the per-path calls
    (same elementwise arithmetic, evaluated over the whole grid at once)."""
    s = cdnt_arc - cdnt_arc[0]
    prof = np.asarray(profs, float)  # (K, 4) rows [a, b, c, d]
    a, b = prof[:, 0:1], prof[:, 1:2]
    c, d = prof[:, 2:3], prof[:, 3:4]
    q = a * s**3 + b * s**2 + c * s + d
    x = way.baseline_x - q * way.d1y
    y = way.baseline_y + q * way.d1x
    return x, y


def _max_curvature(x: np.ndarray, y: np.ndarray) -> float:
    """Reference curvature check (``:1127-1185``): rotate chord to +x, fit
    y(x) spline, evaluate curvature at max(100, n_seg) uniform x samples.

    Runs the native code (``dmv_max_curvature``); the numpy body below is
    its arithmetic oracle, and computes the inputs the native code rejects."""
    k = max_curvature_native(x, y)
    if k is not None:
        return k
    return _max_curvature_numpy(x, y)


def _max_curvature_numpy(x: np.ndarray, y: np.ndarray) -> float:
    chord = np.array([x[-1] - x[0], y[-1] - y[0]])
    ang = np.arccos(np.clip(chord[0] / np.linalg.norm(chord), -1, 1))
    if chord[1] < 0:
        ang = -ang
    R = _rotation(-ang)
    p = np.column_stack([x, y]) @ R.T
    cx, cy = p[:, 0], p[:, 1]
    n_eval = max(100, len(x) - 1)
    u = cx[0] + np.arange(n_eval) * (cx[-1] - cx[0]) / (n_eval - 1)
    b, c, d = fmm_spline_coeffs(cx, cy)
    _, k = spline_eval(cx, cy, b, c, d, u)
    return float(k.max())


def _rect_sweep(path_x, path_y, theta, length, width):
    """Rectangle corners along a path: (…, n, 2, 4) (reference
    ``:1308-1334``); headings below 0 are flipped by +π before rotating.
    Batches over any leading dims — a frame's whole path cluster sweeps in
    one call, elementwise-identical to per-path evaluation."""
    base = np.array(
        [
            [length / 2, -length / 2, -length / 2, length / 2],
            [-width / 2, -width / 2, width / 2, width / 2],
        ]
    )
    rot = np.where(theta < 0, theta + np.pi, theta)
    c, s = np.cos(rot), np.sin(rot)
    R = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
    )  # (..., n, 2, 2)
    rects = np.einsum("...ij,jk->...ik", R, base)
    rects += np.stack([path_x, path_y], axis=-1)[..., None]
    return rects


def generate_ego_cluster(
    ego: Vehicle,
    road: Road,
    k_max: float,
    unit_arc: float,
    way: Way,
    cdnt_arc: np.ndarray,
    m_equal: int,
    time_horizon: float,
    time_step: float,
):
    """Returns (traj_num, ego_rects, usable_paths, unit_arc_paths, k_maxes,
    path_ways) mirroring the reference output tuple.

    - ego_rects: list over usable paths of (101, 2, 4) rectangle sweeps
    - usable_paths: indices of paths meeting the curvature bound
    - unit_arc_paths: per-usable-path uniform arc step
    - k_maxes: final max curvature per candidate (reference ``K_max``)
    """
    actual_lane = road.lane_num if road.cross_centerline else road.lane_egodirect
    traj_num = math.ceil((actual_lane * road.lane_width / ego.width - 1) * 2)
    if actual_lane == 1:
        traj_num = 3

    deviation_right = (ego.lane_posi - 1) * road.lane_width - ego.width / 2
    r_min = 1.0 / k_max
    unit_dev = (actual_lane * road.lane_width - ego.width) / (traj_num - 1)

    seg = []
    qf = []
    for i in range(traj_num):
        dev = abs(deviation_right - unit_dev * i)
        expr = 4 * r_min * dev - dev**2
        root = math.sqrt(expr) if expr > 0 else 0.0
        s = math.ceil((root + r_min * math.sin(-ego.relative_theta)) / unit_arc)
        seg.append(min(max(s, 10), m_equal))
        qf.append(-deviation_right + unit_dev * i)

    # iterative lengthening until every path satisfies the curvature bound.
    # The reference recomputes EVERY path each sweep (``:1240-1300``), but
    # a path whose seg is unchanged (done, or over-limit — the +2/−2 there
    # nets to no change) recomputes to identical values, so only paths
    # whose seg actually grew are recomputed — bit-identical output.
    done = [False] * traj_num
    over = [False] * traj_num
    k_maxes = [0.0] * traj_num
    profiles = [None] * traj_num
    dirty = list(range(traj_num))
    while not all(done):
        if dirty:
            # one batched LAPACK solve for all dirty paths (bit-identical
            # to per-path np.linalg.solve — same gesv per slice)
            for i, prof in zip(dirty, _cubic_lateral_profiles(
                ego, cdnt_arc, [seg[i] for i in dirty], [qf[i] for i in dirty]
            )):
                profiles[i] = prof
            # full-grid path eval in one vectorized op, curvature checks in
            # one native call — per-path values identical (see the helpers)
            xf, yf = _paths_xy_full(
                way, cdnt_arc, [profiles[i] for i in dirty]
            )
            xs = [xf[j, : seg[i] + 1] for j, i in enumerate(dirty)]
            ys = [yf[j, : seg[i] + 1] for j, i in enumerate(dirty)]
            ks = max_curvature_batch_native(xs, ys)
            for i, k, x, y in zip(dirty, ks, xs, ys):
                # a path the native code rejects goes through the scalar
                # path: the numpy oracle computes it or raises
                k_maxes[i] = k if k is not None else _max_curvature(x, y)
        dirty = []
        for i in range(traj_num):
            if done[i]:
                continue
            if k_maxes[i] > k_max:
                seg[i] += 2
                if seg[i] >= m_equal - 1:
                    seg[i] -= 2  # net seg unchanged — no recompute needed
                    over[i] = True
                    done[i] = True
                else:
                    dirty.append(i)
            else:
                done[i] = True

    usable = [i for i in range(traj_num) if not over[i]]

    real_segments = int(math.ceil((ego.speed * time_horizon) / unit_arc)) + 10

    ego_rects: List[np.ndarray] = []
    unit_arc_paths: List[float] = []
    path_ways: List[Way] = []
    point_num = 100

    # per-path x/y (variable lengths: curvature-bounded head + constant-
    # offset baseline extension), evaluated from the full-grid batch
    xs_list: List[np.ndarray] = []
    ys_list: List[np.ndarray] = []
    if usable:
        xf, yf = _paths_xy_full(way, cdnt_arc, [profiles[i] for i in usable])
    for row, i in enumerate(usable):
        x, y = xf[row, : seg[i] + 1], yf[row, : seg[i] + 1]
        # extend at constant offset qf along the remaining baseline
        if seg[i] + 1 < real_segments:
            j = np.arange(seg[i] + 1, real_segments)
            j = j[j < len(way.baseline_x)]
            x = np.concatenate([x, way.baseline_x[j] - qf[i] * way.d1y[j]])
            y = np.concatenate([y, way.baseline_y[j] + qf[i] * way.d1x[j]])
        elif len(x) > real_segments:
            x, y = x[:real_segments], y[:real_segments]
        xs_list.append(x)
        ys_list.append(y)

    # uniform-arc resample of ALL usable paths in one native call (shared
    # point_num → uniform output shapes, consumed as raw batch arrays);
    # rows the native code rejects go through the scalar path (the numpy
    # oracle computes them or raises)
    K = len(xs_list)
    ua, _, tx, ty, bxs, cxs, bys, cys, rc = frenet_batch_native(
        xs_list, ys_list, point_num
    )
    for row in np.flatnonzero(rc != 0):
        o = cartesian_to_frenet(
            np.column_stack([xs_list[row], ys_list[row]]), point_num
        )
        ua[row] = o[0]
        tx[row], ty[row] = o[2][:, 0], o[2][:, 1]
        bxs[row], cxs[row], bys[row], cys[row] = o[3], o[4], o[5], o[6]

    if K:
        # curvature/theta + ego rectangle sweep for the whole cluster in
        # one vectorized op each (elementwise — identical to per-path)
        kb_all, th_all = curvature_theta(bxs, cxs, bys, cys, absolute=True)
        rects_all = _rect_sweep(tx, ty, th_all, ego.length, ego.width)
        for row in range(K):
            unit_arc_paths.append(float(ua[row]))
            path_ways.append(
                Way(
                    baseline_x=tx[row], baseline_y=ty[row],
                    d1x=bxs[row], d2x=cxs[row], d1y=bys[row], d2y=cys[row],
                    kb=kb_all[row], theta=th_all[row],
                )
            )
            ego_rects.append(rects_all[row])

    return traj_num, ego_rects, usable, unit_arc_paths, k_maxes, path_ways
