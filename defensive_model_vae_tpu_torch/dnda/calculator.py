"""DNDA batch driver: score SUT episode CSVs.

Re-implements ``SUT_Testing/tools/DNDA_calculator.py``: per-scenario
straight-line baselines (from the scenario registry), world rotation so
the baseline runs along +x, per-frame vehicle-state rotation, relative
heading / lateral-offset initialization, every-10th-frame evaluation with
the per-scenario stop conditions, DNDA = RL, max over frames.

Port of ``defensive_model_vae_tpu/dnda/calculator.py`` without pandas: an
episode is read as a ``data.csv_io.Frame``.  ``process_episode`` and
``score_directory`` prepare frames on the host and run the collision sweep
as one torch program on the card unless asked for the CPU (``device``);
``host=True`` keeps the JAX package's numpy path (frame by frame, with the
lazy RL == 1 stop; a process pool scoring whole episodes).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .. import scenarios
from ..data.csv_io import read_csv
from .core import (
    finalize_frame,
    prepare_frame,
    sweep_frame_host,
    sweep_frames,
)
from .geometry import Road, Vehicle


def baseline_for(scenario) -> np.ndarray:
    """(N, 2) straight-line baseline for the scenario (registry-backed)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    return sce.dnda.baseline_fn().reshape(-1, 2)


def _rotate_to_x(baseline: np.ndarray):
    """Rotate so the baseline chord runs along +x
    (reference ``rotate_baseline_to_x_direction``, ``:219-230``)."""
    angle = math.atan2(
        baseline[-1, 1] - baseline[0, 1], baseline[-1, 0] - baseline[0, 0]
    )
    # reference quirk: its rotate_point(x, y, -angle) composes to a rotation
    # by +angle, so a chord at +90° lands on the NEGATIVE x axis.  The whole
    # downstream geometry (heading-vs-y conventions, lane side) depends on
    # this orientation, so we replicate it exactly.
    R = np.array([[math.cos(angle), -math.sin(angle)],
                  [math.sin(angle), math.cos(angle)]])
    return baseline @ R.T, angle


def _rotate_row(row, angle: float, max_sv: int) -> Dict[str, float]:
    """Rotate all vehicle states like the baseline (by +angle — see
    ``_rotate_to_x``) and convert yaws to radians measured from the y axis
    (reference ``rotate_vehicle_positions``).  Scalar math — bit-identical
    to the former R @ vec formulation (dot(cos·x, −sin·y) ≡ cos·x − sin·y)."""
    ca, sa = math.cos(angle), math.sin(angle)
    deg = math.degrees(angle)
    out: Dict[str, float] = {}

    def rot(prefix):
        x, y = row[f"{prefix}_x"], row[f"{prefix}_y"]
        vx, vy = row[f"{prefix}_vx"], row[f"{prefix}_vy"]
        axx, ayy = row[f"{prefix}_ax"], row[f"{prefix}_ay"]
        yaw = (row[f"{prefix}_yaw"] - deg) % 360
        out[f"{prefix}_x"], out[f"{prefix}_y"] = ca * x + -sa * y, sa * x + ca * y
        out[f"{prefix}_vx"], out[f"{prefix}_vy"] = ca * vx + -sa * vy, sa * vx + ca * vy
        out[f"{prefix}_ax"], out[f"{prefix}_ay"] = ca * axx + -sa * ayy, sa * axx + ca * ayy
        out[f"{prefix}_yaw"] = math.radians(90 - yaw)

    rot("ego")
    for i in range(1, max_sv + 1):
        if f"sv{i}_x" in row and not (
            np.isnan(row[f"sv{i}_x"]) or np.isnan(row[f"sv{i}_y"])
        ):
            rot(f"sv{i}")
    return out


def _relative_theta_init_q(ego_x, ego_y, ego_yaw, baseline: np.ndarray):
    """Heading offset and signed lateral offset vs the nearest baseline
    segment (reference ``calculate_relative_theta_and_init_q``, ``:80-103``)."""
    d = np.linalg.norm(baseline - np.array([ego_x, ego_y]), axis=1)
    i = int(np.argmin(d))
    nearest = baseline[i]
    nxt = baseline[i + 1] if i < len(baseline) - 1 else baseline[i - 1]
    path_vec = nxt - nearest
    path_yaw = math.atan2(path_vec[1], path_vec[0])
    rel = (ego_yaw - path_yaw + math.pi) % (2 * math.pi) - math.pi
    normal = np.array([-path_vec[1], path_vec[0]])
    init_q = float(
        np.dot(np.array([ego_x, ego_y]) - nearest, normal) / np.linalg.norm(path_vec)
    )
    return rel, init_q


def _sur_input(row: Dict[str, float], max_sv: int, sce) -> np.ndarray:
    """Surrounding-vehicle rows [x, y, len, wid, vx, vy, ax, ay, yaw]
    (reference ``generate_surVhe_input``, ``:176-207``); bikes get 2.0×0.7
    (``sce.dnda.bike_svs`` — sce1's sv2, sce3's sv1), cars 4.0×2.0."""
    rows = []
    for i in range(1, max_sv + 1):
        if f"sv{i}_x" not in row:
            continue
        if i in sce.dnda.bike_svs:
            L, W = 2.0, 0.7
        else:
            L, W = 4.0, 2.0
        # plain indexing, not .get-with-default: _rotate_row writes the
        # full x/y/vx/vy/ax/ay/yaw set per vehicle or nothing, so the
        # sv{i}_x membership check above already guarantees the rest —
        # defaults here would fake a missing-column tolerance the
        # pipeline does not have (a CSV lacking sv1_ax KeyErrors in
        # _rotate_row long before this point)
        rows.append(
            [
                row[f"sv{i}_x"], row[f"sv{i}_y"], L, W,
                row[f"sv{i}_vx"], row[f"sv{i}_vy"],
                row[f"sv{i}_ax"], row[f"sv{i}_ay"],
                row[f"sv{i}_yaw"],
            ]
        )
    return np.asarray(rows) if rows else np.zeros((0, 9))


def _should_stop(sce, row: Dict[str, float]) -> bool:
    """Per-scenario episode stop conditions (reference ``:317-338``),
    centralized in the registry (``scenarios._dnda_stop_*``)."""
    return sce.dnda.stop_fn(row)


@dataclasses.dataclass
class DndaResult:
    frames: List[int]
    dnda: List[float]

    @property
    def max_dnda(self) -> float:
        return max(self.dnda) if self.dnda else float("-inf")


_EPISODE_RE = re.compile(r"^(?P<model>[^_]+)_(?P<scenario>[^_]+)_(?P<trial>\d+)\.csv$")


def _score_one(args):
    path, scenario, kwargs = args
    res = process_episode(path, scenario, host=True, **kwargs)
    return str(path), res.max_dnda, len(res.frames)


def _prep_one(args):
    """Pool worker for the torch-sweep path: host preparation only (no torch,
    no CUDA)."""
    path, scenario, kwargs = args
    frames, preps = prepare_episode(path, scenario, **kwargs)
    return str(path), frames, preps


def score_directory(
    directory,
    out_csv: Optional[str] = None,
    processes: Optional[int] = None,
    device="cuda",
    host: bool = False,
    **episode_kwargs,
):
    """Score every ``<model>_<scenario>_<trial>.csv`` episode in a directory
    and summarize the max DNDA per file (reference ``DNDA_calculator.main``
    → ``max_dnda_summary.csv``, ``:371-453``).

    By default the pool does host preparation only, then the parent runs
    the SAT collision sweep for ALL episodes' frames as ONE batched torch
    program on ``device`` (frames × paths × ego points × vehicles × 4
    axes; the card unless ``device="cpu"``).  ``host=True``: episodes are
    scored end to end in a host process pool (numpy sweep), the oracle
    path; the rows are identical.  The workers are spawned and never touch
    CUDA.

    Returns a list of dicts; writes ``out_csv`` when given.
    """
    import concurrent.futures
    import csv as _csv
    import multiprocessing

    if not host:
        from .._device import resolve_device

        device = resolve_device(device)  # raise before any worker starts
    directory = Path(directory)
    jobs = []
    for p in sorted(directory.rglob("*.csv")):
        m = _EPISODE_RE.match(p.name)
        if not m:
            continue
        town = m.group("scenario")
        try:
            sce = scenarios.get(town)
        except KeyError:
            continue  # e.g. FreeDriveTown05 — skipped by the reference too
        jobs.append((str(p), sce.key, episode_kwargs))

    rows = []
    n_workers = processes if processes is not None else (os.cpu_count() or 1)
    if n_workers <= 1:
        # no parallelism to gain — run inline and skip the spawn +
        # prep-pickling overhead entirely
        mapper = map
        ex = None
    else:
        # spawn, not fork: the parent may hold CUDA and torch's threads
        ex = concurrent.futures.ProcessPoolExecutor(
            max_workers=processes, mp_context=multiprocessing.get_context("spawn")
        )
        mapper = ex.map
    try:
        if not host:
            prepped = list(mapper(_prep_one, jobs))
            # one torch program over every frame of every episode
            all_preps = [p for _, _, preps in prepped for p in preps]
            all_cis = sweep_frames(all_preps, device=device)
            results, k = [], 0
            for path, frames, preps in prepped:
                res = _finalize_episode(frames, preps, all_cis[k : k + len(preps)])
                results.append((path, res.max_dnda, len(res.frames)))
                k += len(preps)
        else:
            results = list(mapper(_score_one, jobs))
    finally:
        if ex is not None:
            ex.shutdown()
    for (path, sce_key, _), (p, max_d, n) in zip(jobs, results):
        m = _EPISODE_RE.match(Path(path).name)
        rows.append(
            {
                "model": m.group("model"),
                "scenario": m.group("scenario"),
                "trial": int(m.group("trial")),
                "max_dnda": max_d,
                "frames": n,
                # path RELATIVE to the scanned root (reference
                # ``DNDA_calculator.py:433``): rglob descends into
                # subfolders, and a bare basename would collide for
                # same-named episodes in different subfolders (for the
                # flat SUT corpus, relative == basename, so the committed
                # summary is unchanged)
                "file_path": str(Path(path).relative_to(directory)),
            }
        )
    if out_csv:
        # fixed field order so an episode-less directory still writes a
        # valid (header-only) summary instead of crashing on rows[0]
        fields = ["model", "scenario", "trial", "max_dnda", "frames", "file_path"]
        with open(out_csv, "w", newline="") as f:
            writer = _csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            writer.writerows(rows)
    return rows


def _iter_frame_preps(
    csv_path,
    scenario,
    frame_stride: int = 10,
    time_horizon: float = 3.0,
    time_step: float = 0.1,
    basepoint_num: int = 400,
    max_frames: Optional[int] = None,
):
    """Yield (frame_number, FramePrep) for every scorable frame of one SUT
    episode (reference ``process_file``, ``:286-364``, up to the collision
    sweep)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    df = read_csv(csv_path)
    baseline, angle = _rotate_to_x(baseline_for(sce))

    sv_cols = [c for c in df.columns if re.fullmatch(r"sv\d+_x", c)]
    max_sv = max((int(re.search(r"sv(\d+)_x", c).group(1)) for c in sv_cols), default=0)

    moving = (df["ego_vx"] != 0) | (df["ego_vy"] != 0)
    start_frame = int(np.flatnonzero(moving)[0]) if moving.any() else 0

    n_yielded = 0
    cfg = sce.dnda
    # lazy plain-dict rows: only every frame_stride-th row past the start is
    # ever read; numpy scalars are IEEE doubles, as in the JAX package
    col_arrays = {c: df[c] for c in df.columns}
    for idx in range(len(df)):
        frame = idx + 1
        if frame % frame_stride != 0 or frame < start_frame:
            continue
        raw = {c: v[idx] for c, v in col_arrays.items()}
        if _should_stop(sce, raw):
            break
        row = _rotate_row(raw, angle, max_sv)
        rel_theta, init_q = _relative_theta_init_q(
            row["ego_x"], row["ego_y"], row["ego_yaw"], baseline
        )
        # reference quirk (``:111``): relative theta is passed through
        # deg2rad once more even though it is already radians
        rel_theta = math.radians(rel_theta)

        road = Road(
            cross_centerline=False,
            lane_num=cfg.lane_num,
            lane_egodirect=cfg.lane_egodirect,
            lane_width=cfg.lane_width,
            max_absolute_acc=cfg.max_absolute_acc,
        )
        ego = Vehicle(
            x=row["ego_x"], y=row["ego_y"], length=7.2, width=2.3,
            speed_x=row["ego_vx"], speed_y=row["ego_vy"],
            speed=math.hypot(row["ego_vx"], row["ego_vy"]),
            absolute_theta=row["ego_yaw"],
            acc=math.cos(row["ego_yaw"]) * row["ego_ax"]
            + math.sin(row["ego_yaw"]) * row["ego_ay"],
            init_q=init_q, lane_posi=1, relative_theta=rel_theta,
        )
        sur = _sur_input(row, max_sv, sce)
        try:
            prep = prepare_frame(
                time_horizon, time_step, road, ego, baseline, sur, basepoint_num
            )
        except (ValueError, ZeroDivisionError):
            continue
        yield frame, prep
        n_yielded += 1
        if max_frames is not None and n_yielded >= max_frames:
            break


def prepare_episode(csv_path, scenario, **kwargs):
    """All scorable frames of one episode, prepared on the host.

    Returns (frame_numbers, FramePrep list).  The reference's RL==1 early
    stop is applied AFTER scoring (:func:`_finalize_episode`) — preparing
    frames past a would-be stop is redundant work but yields identical
    results."""
    pairs = list(_iter_frame_preps(csv_path, scenario, **kwargs))
    return [f for f, _ in pairs], [p for _, p in pairs]


def _finalize_episode(frames, preps, cis) -> DndaResult:
    """DA/RL per frame + the reference's stop-at-RL==1 truncation.

    Per-frame errors skip the frame (the pre-refactor behavior, which
    wrapped the whole DA/RL computation)."""
    out_frames: List[int] = []
    values: List[float] = []
    for frame, prep, ci in zip(frames, preps, cis):
        try:
            _, rl = finalize_frame(prep, ci)
        except (ValueError, ZeroDivisionError):
            continue
        out_frames.append(frame)
        values.append(rl)
        if rl == 1:
            break
    return DndaResult(out_frames, values)


def process_episode(
    csv_path,
    scenario,
    frame_stride: int = 10,
    time_horizon: float = 3.0,
    time_step: float = 0.1,
    basepoint_num: int = 400,
    max_frames: Optional[int] = None,
    device="cuda",
    host: bool = False,
) -> DndaResult:
    """Score one SUT episode CSV (reference ``process_file``, ``:286-364``).

    By default the episode's SAT collision sweep runs as one batched torch
    program on ``device`` (:mod:`.device_sweep`; the card unless
    ``device="cpu"``); ``host=True`` runs the frame-by-frame numpy path,
    which also keeps the reference's lazy RL == 1 early stop.  The results
    are identical.
    """
    kwargs = dict(
        frame_stride=frame_stride, time_horizon=time_horizon,
        time_step=time_step, basepoint_num=basepoint_num,
        max_frames=max_frames,
    )
    if not host:
        frames, preps = prepare_episode(csv_path, scenario, **kwargs)
        cis = sweep_frames(preps, device=device)
        return _finalize_episode(frames, preps, cis)

    frames: List[int] = []
    values: List[float] = []
    for frame, prep in _iter_frame_preps(csv_path, scenario, **kwargs):
        try:
            _, rl = finalize_frame(prep, sweep_frame_host(prep))
        except (ValueError, ZeroDivisionError):
            continue  # skip the frame, like the reference driver
        frames.append(frame)
        values.append(rl)
        if rl == 1:
            break
    return DndaResult(frames, values)
