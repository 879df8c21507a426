"""DNDA main algorithm: DA + RL for one frame.

Re-implements ``DrivableArea_RiskLevel_Calculation``
(``dnda_functions.py:518-909``): rotate the world so the reference path
is y-aligned in the ego frame, crop the baseline near the ego, translate
to the origin, two-pass Frenet resampling (coarse 50 segments → ~1 m
arc steps), build the reference Way, generate the ego path cluster,
predict surrounding vehicles, run the SAT sweep, and compute DA and RL.

Port of ``defensive_model_vae_tpu/dnda/core.py``.  The host preparation and
the DA/RL finish are the JAX package's numpy; :func:`sweep_frames` runs the
batched collision sweep as a torch program on the card by default
(:mod:`.device_sweep`), on the CPU when asked, and the numpy oracle
:func:`sweep_frame_host` only with ``host=True``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from .collision import collision_indices, predict_surrounding_rectangles
from .frenet import Way, cartesian_to_frenet
from .geometry import Road, SurroundingVehicle, Vehicle
from .paths import generate_ego_cluster
from .risk import drivable_area, risk_level
from .spline import frenet_two_pass_native


@dataclasses.dataclass
class FramePrep:
    """Host-side precomputation for one frame: everything up to (but not
    including) the SAT collision sweep, so the sweep itself can be batched
    across frames on the device (:mod:`.device_sweep`)."""

    ego_rects: List[np.ndarray]  # per usable path, (N, 2, 4)
    usable: List[int]
    unit_arc_paths: List[float]
    k_maxes: List[float]
    sur_array: np.ndarray  # (V, 9) rotated-frame vehicle rows
    ego_speed: float
    time_horizon: float
    time_step: float


def prepare_frame(
    time_horizon: float,
    time_step: float,
    road: Road,
    ego: Vehicle,
    baseline_xy: np.ndarray,
    sur_input: np.ndarray,
    basepoint_num: int = 400,
) -> FramePrep:
    """Frame rotation + Frenet resampling + ego path cluster + surrounding
    vehicle transform (reference ``:561-892``) — the data-dependent host
    part of ``DrivableArea_RiskLevel_Calculation``."""
    # ego absolute heading from the velocity vector (angle w.r.t. the y
    # axis, sign from the x quadrant — reference ``:562-578``)
    if ego.speed_x**2 + ego.speed_y**2 != 0:
        direct = np.array([ego.speed_x, ego.speed_y])
        n = np.linalg.norm(direct)
        x_deg = math.acos(np.clip(direct[0] / n, -1, 1))
        y_deg = math.acos(np.clip(direct[1] / n, -1, 1))
        ego.absolute_theta = -y_deg if x_deg < math.pi / 2 else y_deg

    path_y_deg = ego.absolute_theta - ego.relative_theta
    c, s = math.cos(-path_y_deg), math.sin(-path_y_deg)
    R = np.array([[c, -s], [s, c]])

    base = np.asarray(baseline_xy, float) @ R.T  # rotated baseline
    ego_xy = R @ np.array([ego.x, ego.y])

    # crop basepoint_num points starting at the nearest baseline point.
    # DELIBERATE DEVIATION on short crops (4..basepoint_num-1 points
    # remaining): the reference's copy loop (``:678-688``) silently
    # yields an all-zeros 400-point crop there, which degenerates into a
    # NaN chord rotation or the Cartesian_trans_Frenet infinite loop
    # (SURVEY §5 latent defects) — it can never score such a frame.  We
    # score against the truncated baseline instead (a real, if shorter,
    # drivable corridor); only crops with <4 points (no cubic spline
    # possible) are rejected for the episode driver to skip.
    d2 = np.sum((base - ego_xy) ** 2, axis=1)
    min_idx = int(np.argmin(d2))
    end = min(min_idx + basepoint_num, len(base))
    if end - min_idx < 4:
        raise ValueError("not enough baseline points ahead of the ego")
    crop = base[min_idx:end]
    origin = crop[0].copy()
    crop = crop - origin

    # transform surrounding vehicles into the same frame
    sur: List[SurroundingVehicle] = []
    for row in np.atleast_2d(np.asarray(sur_input, float)):
        if len(row) == 0:
            continue
        pos = R @ row[0:2] - origin
        vel = R @ row[4:6]
        acc = R @ row[6:8]
        sur.append(
            SurroundingVehicle(
                x=pos[0], y=pos[1], length=row[2], width=row[3],
                speed_x=vel[0], speed_y=vel[1], acc_x=acc[0], acc_y=acc[1],
                heading=row[8] - path_y_deg,
            )
        )

    # curvature bound from lateral-acceleration budget and steering limit.
    # Preserved quirk: when |ego.acc| >= max_absolute_acc the reference
    # computes np.sqrt(negative) -> nan and Python's min(1/6, nan) returns
    # its FIRST argument (dnda_functions.py:610-616), so over-budget frames
    # fall back to the steering-limit curvature 1/6 rather than zero.  We
    # reproduce that (and also route the measure-zero |acc| == a_max case
    # through it — the reference's k_lat = 0 there would divide-by-zero at
    # r_min = 1/k_max, a latent defect we fix rather than reproduce).
    lat_sq = road.max_absolute_acc**2 - ego.acc**2
    if lat_sq > 0 and ego.speed != 0:
        k_lat = math.sqrt(lat_sq) / ego.speed**2
    else:
        k_lat = float("inf")
    k_max = min(1.0 / 6.0, k_lat)

    # two-pass Frenet: coarse to measure length, then ~1 m arc steps —
    # fused into one native crossing; an input the native code rejects
    # takes the two scalar calls (identical arithmetic)
    fused = frenet_two_pass_native(crop, 50, 1.0)
    if fused is not None:
        unit_arc, _, trans, bx, cx, by, cy, s_grid, m_equal = fused
    else:
        _, arc_len, *_ = cartesian_to_frenet(crop, 50)
        m_equal = round(arc_len / 1.0)
        unit_arc, _, trans, bx, cx, by, cy, s_grid = cartesian_to_frenet(
            crop, m_equal
        )
    way = Way(
        baseline_x=trans[:, 0], baseline_y=trans[:, 1],
        d1x=bx, d2x=cx, d1y=by, d2y=cy,
    ).compute_curvature(absolute=False)

    traj_num, ego_rects, usable, unit_arc_paths, k_maxes, _ = generate_ego_cluster(
        ego, road, k_max, unit_arc, way, s_grid, m_equal, time_horizon, time_step
    )

    # a degenerate path (zero/nonfinite arc step) would divide-by-zero in
    # the host sweep and silently poison the batched device sweep — reject
    # the frame here so BOTH paths skip it identically (the episode driver
    # catches ValueError per frame, like the pre-refactor code did around
    # the whole DA/RL computation)
    if not all(np.isfinite(u) and u > 0 for u in unit_arc_paths):
        raise ValueError("degenerate path arc step in cluster")

    sur_array = (
        np.stack([v.as_array() for v in sur]) if sur else np.zeros((0, 9))
    )
    return FramePrep(
        ego_rects=ego_rects,
        usable=usable,
        unit_arc_paths=unit_arc_paths,
        k_maxes=k_maxes,
        sur_array=sur_array,
        ego_speed=ego.speed,
        time_horizon=time_horizon,
        time_step=time_step,
    )


def sweep_frame_host(prep: FramePrep) -> np.ndarray:
    """Numpy collision sweep for one prepared frame (the exactness oracle
    for the batched device sweep)."""
    sur = [
        SurroundingVehicle(*row) for row in np.atleast_2d(prep.sur_array) if len(row)
    ]
    sur_rects = predict_surrounding_rectangles(
        sur, prep.time_horizon, prep.time_step
    )
    return collision_indices(
        prep.ego_rects,
        sur_rects,
        prep.ego_speed,
        prep.unit_arc_paths,
        prep.time_horizon,
        prep.time_step,
    )


def finalize_frame(prep: FramePrep, ci: np.ndarray) -> Tuple[float, float]:
    """(DA, RL) from a prepared frame and its collision indices."""
    da = drivable_area(len(prep.usable), prep.ego_rects, ci)
    rl = risk_level(
        prep.usable,
        prep.k_maxes,
        ci,
        prep.unit_arc_paths,
        prep.ego_speed,
        prep.time_horizon,
    )
    return da, rl


def sweep_frames(
    preps: Sequence[FramePrep],
    device="cuda",
    sat_dtype: str = "float32",
    host: bool = False,
    mesh=None,
) -> List[np.ndarray]:
    """Collision indices for many prepared frames: one batched torch program
    on ``device`` (:mod:`.device_sweep`; the card by default, ``"cpu"`` runs
    the same program on the CPU), or with ``host=True`` the numpy oracle
    frame by frame.

    ``sat_dtype`` applies to the torch sweep's SAT geometry only (the window
    bookkeeping stays float64); both float32 and float64 are held
    index-identical to the numpy oracle.  ``mesh`` (``parallel.create_mesh``;
    the sweep on its device) cuts the frame axis into contiguous blocks over
    its data axis (JAX's ``NamedSharding`` of the frames): each rank sweeps
    its block and the blocks' indices are gathered to every rank in frame
    order, so the result is index for index the one-device sweep's."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh, gather_objects

        check_mesh(mesh)
        dp, d = mesh.shape["data"], mesh.data_index
        bounds = np.linspace(0, len(preps), dp + 1).round().astype(int)
        mine = list(preps[bounds[d]:bounds[d + 1]])
        return gather_objects(sweep_frames(mine, mesh.device, sat_dtype, host), mesh)
    if host:
        return [sweep_frame_host(p) for p in preps]
    from .._device import resolve_device
    from .device_sweep import sweep_frames_device

    if not preps:
        resolve_device(device)  # no frames, but the card is still asked for
        return []
    if any(
        (p.time_horizon, p.time_step) != (preps[0].time_horizon, preps[0].time_step)
        for p in preps
    ):
        raise ValueError(
            "device sweep requires one (time_horizon, time_step) across "
            "the batch — sweep mixed-horizon frames separately"
        )
    return sweep_frames_device(
        [p.ego_rects for p in preps],
        [p.unit_arc_paths for p in preps],
        [p.ego_speed for p in preps],
        [p.sur_array for p in preps],
        preps[0].time_horizon,
        preps[0].time_step,
        sat_dtype=sat_dtype,
        device=device,
    )


def drivable_area_risk_level(
    time_horizon: float,
    time_step: float,
    road: Road,
    ego: Vehicle,
    baseline_xy: np.ndarray,
    sur_input: np.ndarray,
    basepoint_num: int = 400,
) -> Tuple[float, float]:
    """Compute (DA, RL) for one frame (reference
    ``DrivableArea_RiskLevel_Calculation``, ``dnda_functions.py:518-909``).

    Args:
        baseline_xy: (N, 2) reference path points.
        sur_input: (V, 9) rows [x, y, len, wid, vx, vy, ax, ay, heading].
    """
    prep = prepare_frame(
        time_horizon, time_step, road, ego, baseline_xy, sur_input, basepoint_num
    )
    return finalize_frame(prep, sweep_frame_host(prep))
