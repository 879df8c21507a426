"""End-to-end pipeline: episode CSVs → generate → track → validate.

Port of ``defensive_model_vae_tpu/pipeline.py``:

- the device half: ``default_mpc_cfg`` (:58), ``_valid_waypoint_times``
  (:79), ``_draw_valid_samples`` (:181, with its ``seed + 1000·retry``
  re-draw fold), and the sampling and tracking of ``generate_and_track``
  (:107) and ``generate_and_track_multi`` (:212) from given start points as
  :func:`generate_and_track_from_starts` and
  :func:`generate_and_track_multi_from_starts`; :func:`fixture_starts`
  derives start points from the committed windows;
- the CSV half: :func:`generate_and_track` and
  :func:`generate_and_track_multi` read their start points from the
  episode CSVs (``data.get_start_conditions``) around that device half;
  :func:`save_tracked` / :func:`load_tracked` keep per-trace npy files with
  the reference's naming scheme; :func:`validate` is the full metric sweep
  (JS, RMSE_frequency variants, STV surface RMSEs, plane RMSE) as one dict;
  :func:`provenance` and :func:`run_scenario` (:588) the one-shot workflow
  that writes ``validation_<sce>.json``;
- :func:`reproduce_scoreboard` (:457) runs :func:`run_scenario` for every
  scenario at the seeds recorded in the committed artifacts, writes
  ``scoreboard.json`` against the published-best values and, with
  ``check=True``, holds every regenerated metric to its committed value.
  Its numbers describe whatever episode tree ``data_root`` holds: on trees
  written from the committed windows (``scripts/episodes.py``) they are
  not the published values, which need the CARLA logs.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import scenarios
from .control import MPCConfig, track_batch
from .data import (
    collect_csv_files,
    get_human_and_bv_trajectories,
    get_start_conditions,
    trim_human_trajectory,
)
from .generate import generate_trajectories
from .metrics import (
    build_stv_surface,
    extract_coordinates,
    extract_velocities,
    human_stv_data,
    human_velocities,
    model_stv_data,
    rmse_frequency,
    rmse_frequency_trajcount,
    spatiotemporal_plane_rmse,
    surface_rmse,
    velocity_js_divergence,
)
from .models import CVAEConfig
from .utils.reporting import jsonable

# grid size of every validation metric AND of the provenance block that
# describes it (reference Distribution.main, ``Distribution.py:511`` — the
# setting behind the published RMSE_frequency values).  ONE constant so the
# self-describing artifacts cannot drift from the run configuration.
GRID_SIZE_M = 0.5


def default_mpc_cfg(sce) -> MPCConfig:
    """The tracker configuration of every validation run."""
    return MPCConfig(prediction_horizon=30, control_horizon=20, dt=sce.dt)


def _valid_waypoint_times(gen: np.ndarray) -> np.ndarray:
    """Per-sample mask: times strictly increasing after the first timestamp
    is zeroed, which needs t1 > 0 as well as an increasing tail."""
    return np.all(np.diff(gen[:, 1:, 0], axis=1) > 0, axis=1) & (gen[:, 1, 0] > 0)


def _draw_valid_samples(params, model_cfg: CVAEConfig, starts: np.ndarray,
                        seed: int, shift_start: bool = True):
    """One z-sample per start point; samples whose times are not monotone
    are re-drawn with seed ``seed + 1000·retry`` (up to 3 times).
    → (gen (B, T, D) numpy, ok mask (B,))."""

    def _draw(s):
        g = generate_trajectories(params, model_cfg, starts, n_samples=1,
                                  seed=s, shift_start=shift_start)
        return np.array(g).reshape(len(starts), model_cfg.seq_len, model_cfg.dim)

    gen = _draw(seed)
    ok = _valid_waypoint_times(gen)
    for retry in range(1, 4):
        if ok.all():
            break
        redraw = _draw(seed + 1000 * retry)
        replace = ~ok & _valid_waypoint_times(redraw)
        gen[replace] = redraw[replace]
        ok |= replace
    return gen, ok


def fixture_starts(windows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Start points (B, 2) and initial states (B, 5) [x, y, θ, vx, vy] of
    fixture windows: heading and speed from the first two waypoints, as
    ``tests/test_mpc.py`` derives them."""
    wp = windows[:, :, [1, 2, 0]].astype(float)
    wp[:, 0, 2] = 0.0
    v0 = (wp[:, 1, :2] - wp[:, 0, :2]) / (wp[:, 1, 2] - wp[:, 0, 2])[:, None]
    inits = np.column_stack([wp[:, 0, 0], wp[:, 0, 1],
                             np.arctan2(v0[:, 1], v0[:, 0]), v0[:, 0], v0[:, 1]])
    return windows[:, 0, 1:3].astype(np.float32), inits


def _waypoints(gen: np.ndarray) -> np.ndarray:
    """[t, x, y] samples → [x, y, t] waypoints, first timestamp zeroed."""
    wps = gen[:, :, [1, 2, 0]].astype(float)
    wps[:, 0, 2] = 0.0
    return wps


def _track_rows(params, wps: np.ndarray, inits: np.ndarray,
                mpc_cfg: MPCConfig) -> List[np.ndarray]:
    """Track the rows in ONE ``track_batch`` call on the params' device;
    → each row's state trace [N_b + 1, 4], clipped to its own step count."""
    if not len(wps):
        return []
    dev = params["dec_3"]["w"].device
    _, states, _, steps = track_batch(wps, inits, mpc_cfg, device=dev)
    return [states[row, : int(steps[row]) + 1].copy() for row in range(len(wps))]


def generate_and_track_from_starts(params, cfg: CVAEConfig, starts: np.ndarray,
                                   initial_states: np.ndarray, seed: int,
                                   mpc_cfg: MPCConfig, shift_start: bool = True
                                   ) -> Tuple[List[np.ndarray], np.ndarray]:
    """One sampled trajectory per start point, tracked in one batch.

    ``mpc_cfg`` is the scenario's tracker, ``default_mpc_cfg(scenario)``
    for a validation run.  → (state traces [N_b + 1, 4] clipped to each
    path's own step count, indices of the start points whose sample was
    valid)."""
    gen, ok = _draw_valid_samples(params, cfg, starts, seed, shift_start)
    idx = np.flatnonzero(ok)
    return _track_rows(params, _waypoints(gen)[idx], initial_states[idx], mpc_cfg), idx


def generate_and_track_multi_from_starts(params, cfg: CVAEConfig, starts: np.ndarray,
                                         initial_states: np.ndarray, seeds: Sequence[int],
                                         mpc_cfg: MPCConfig
                                         ) -> Dict[int, Tuple[List[np.ndarray], np.ndarray]]:
    """:func:`generate_and_track_from_starts` for many generation seeds,
    every seed's valid samples tracked in ONE ``track_batch`` call.

    Each seed's draws and re-draws are those of a per-seed call.  Rows are
    independent in the tracker, so a row's trace is the per-seed call's up
    to the rounding of batched products of another batch width; the batch
    is not padded (JAX pads it to a multiple of 64 rows only to spare XLA a
    recompile, which eager torch does not have).  Seeds whose re-draw
    streams ``seed + 1000·retry`` would alias another seed's base stream are
    refused, as are duplicates.  → {seed: (traces, indices of the start
    points whose sample was valid)}."""
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError("duplicate seeds in generate_and_track_multi_from_starts")
    alias = set(seeds) & {s + 1000 * r for s in seeds for r in (1, 2, 3)}
    if alias:
        raise ValueError(
            f"seed set aliases the degenerate-redraw streams (seeds {sorted(alias)} "
            "equal another seed + 1000*retry); keep band seeds < 1000")
    wps, inits, idx = [], [], {}
    for s in seeds:
        gen, ok = _draw_valid_samples(params, cfg, starts, s)
        idx[s] = np.flatnonzero(ok)
        wps.append(_waypoints(gen)[idx[s]])
        inits.append(initial_states[idx[s]])
    traces = _track_rows(params, np.concatenate(wps), np.concatenate(inits), mpc_cfg)
    out, row = {}, 0
    for s in seeds:
        out[s] = (traces[row:row + len(idx[s])], idx[s])
        row += len(idx[s])
    return out


# ---------------------------------------------------------------------------
# the CSV half
# ---------------------------------------------------------------------------

def _csv_trace_name(scenario_key: str, csv_path: str) -> str:
    """``exp_11_control_<Town>_3.csv → tracked_trajectory_<sce>_exp11_3.npy``
    (reference naming, ``Distribution.py:157``)."""
    parts = os.path.basename(csv_path).split("_")
    if len(parts) < 3 or parts[0] != "exp":
        # a stray CSV in a maneuver folder fails loudly with the file named
        # (generate_and_track validates names up front so this fires BEFORE
        # the expensive generate+track device pass)
        raise ValueError(
            f"unrecognized episode CSV name {os.path.basename(csv_path)!r} "
            "(expected exp_<n>_..._<suffix>.csv)"
        )
    return f"tracked_trajectory_{scenario_key}_exp{parts[1]}_{parts[-1].split('.')[0]}.npy"


def _validated_trace_names(scenario_key: str, csv_files: Sequence[str]):
    """Trace names for every CSV, failing loudly on malformed names AND on
    collisions: same-numbered episodes in different maneuver subfolders
    would map to the same ``tracked_trajectory_*`` file and silently
    overwrite each other in :func:`save_tracked`."""
    names = [_csv_trace_name(scenario_key, c) for c in csv_files]
    seen: Dict[str, str] = {}
    for name, c in zip(names, csv_files):
        if name in seen:
            raise ValueError(
                f"trace-name collision: {seen[name]!r} and {c!r} both map "
                f"to {name!r} (exp number + trial suffix must be unique "
                "across a scenario's maneuver folders)"
            )
        seen[name] = c
    return names


def csv_starts(scenario, csv_files: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Start points (B, 2) float32 and initial states (B, 5) [x, y, θ, vx,
    vy] of the episode CSVs (``data.get_start_conditions``, with its
    per-scenario fallbacks)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    conds = [get_start_conditions(c, sce) for c in csv_files]
    starts = np.array([[c.x, c.y] for c in conds], np.float32)
    return starts, np.stack([c.as_state() for c in conds])


def generate_and_track(
    params,
    model_cfg: CVAEConfig,
    scenario,
    csv_files: Sequence[str],
    seed: int = 0,
    mpc_cfg: Optional[MPCConfig] = None,
    shift_start: bool = True,
    timer=None,
) -> Tuple[List[np.ndarray], List[str]]:
    """Generate one tracked trajectory per CSV (JAX ``pipeline.py:107``).

    The start points come from the CSVs (:func:`csv_starts`); sampling and
    tracking are :func:`generate_and_track_from_starts`'s, one batched
    decode and ONE ``track_batch`` call at the exact surviving width (no
    64-row bucket), so on the same starts the traces are that function's
    bit for bit.  ``shift_start=False`` is the legacy non-offset decoder
    convention (``offset_mode: False`` in a manifest; :func:`run_scenario`
    threads the manifest value).

    ``timer`` (optional ``utils.profiling.StageTimer``) accumulates the
    three sub-stages under ``<sce>_conditions`` (host, every CSV),
    ``<sce>_generate`` (sampling incl. degenerate re-draws) and
    ``<sce>_track`` (the batched MPC).

    Returns (state traces [N_b + 1, 4] clipped to each path's own step
    count, trace names)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    if mpc_cfg is None:
        mpc_cfg = default_mpc_cfg(sce)
    stage = ((lambda name: timer.stage(f"{sce.key}_{name}")) if timer is not None
             else (lambda name: contextlib.nullcontext()))

    # validate trace names (format + collisions) before any device work
    _validated_trace_names(sce.key, csv_files)
    with stage("conditions"):
        starts, inits = csv_starts(sce, csv_files)
    with stage("generate"):
        gen, ok = _draw_valid_samples(params, model_cfg, starts, seed, shift_start)
    idx = np.flatnonzero(ok)
    traces: List[np.ndarray] = []
    if len(idx):
        with stage("track"):
            traces = _track_rows(params, _waypoints(gen)[idx], inits[idx], mpc_cfg)
    return traces, [_csv_trace_name(sce.key, csv_files[b]) for b in idx]


def generate_and_track_multi(
    params,
    model_cfg: CVAEConfig,
    scenario,
    csv_files: Sequence[str],
    seeds: Sequence[int],
    mpc_cfg: Optional[MPCConfig] = None,
) -> Dict[int, Tuple[List[np.ndarray], List[str]]]:
    """:func:`generate_and_track` for many generation seeds in ONE tracking
    batch (JAX ``pipeline.py:212``): the CSVs' start points through
    :func:`generate_and_track_multi_from_starts`, unpadded.

    Returns ``{seed: (traces, names)}``."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    if mpc_cfg is None:
        mpc_cfg = default_mpc_cfg(sce)
    names = _validated_trace_names(sce.key, csv_files)
    starts, inits = csv_starts(sce, csv_files)
    multi = generate_and_track_multi_from_starts(params, model_cfg, starts, inits, seeds,
                                                 mpc_cfg)
    return {s: (traces, [names[b] for b in idx]) for s, (traces, idx) in multi.items()}


def save_tracked(traces: Sequence[np.ndarray], names: Sequence[str], out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, n in zip(traces, names):
        p = os.path.join(out_dir, n)
        np.save(p, t)
        paths.append(p)
    return paths


def load_tracked(directory: str, scenario_key: str) -> List[np.ndarray]:
    """Load every tracked trace for one scenario from a GeneratedData dir.

    Matches the exact generated prefix, not a bare substring: a substring
    match would pull a hypothetical 'sce10' into every 'sce1' sweep and
    np.load any stray file with the key in its name."""
    prefix = f"tracked_trajectory_{scenario_key}_"
    out = []
    for f in sorted(os.listdir(directory)):
        if f.startswith(prefix) and f.endswith(".npy"):
            out.append(np.load(os.path.join(directory, f)))
    return out


def load_humans(scenario, csv_files: Sequence[str]) -> List[np.ndarray]:
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    out = []
    for c in csv_files:
        h, _, _ = get_human_and_bv_trajectories(c, sce)
        if h is not None:
            out.append(trim_human_trajectory(h, sce))
    return out


def validate(
    tracked: Sequence[np.ndarray],
    humans: Sequence[np.ndarray],
    scenario,
    stv_axis: Optional[str] = None,
) -> Dict[str, float]:
    """Full metric sweep → one flat dict (JAX ``pipeline.py:336``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    if stv_axis is None:
        # space axis = the one the scenario drives along (registry field)
        stv_axis = sce.stv_axis

    if len(tracked) == 0 or len(humans) == 0:
        # tolerate empty inputs (e.g. every z-draw degenerate, or no CSVs
        # matched) with an explicit NaN report instead of a cryptic crash
        # inside np.concatenate/min below
        nan = float("nan")
        return {
            "velocity_js_divergence": nan,
            "rmse_frequency_points": nan,
            "rmse_frequency_trajcount": nan,
            "surface_rmse_with_zeros": nan,
            "surface_rmse_no_zeros": nan,
            "plane_centroid_rmse": nan,
            "n_tracked": len(tracked),
            "n_human": len(humans),
        }

    gv = extract_velocities(tracked)
    hv = human_velocities(humans)
    out: Dict[str, float] = {
        "velocity_js_divergence": velocity_js_divergence(gv, hv),
        "rmse_frequency_points": rmse_frequency(
            extract_coordinates(tracked), extract_coordinates(humans), sce,
            GRID_SIZE_M,
        ),
        "rmse_frequency_trajcount": rmse_frequency_trajcount(
            tracked, humans, sce, GRID_SIZE_M
        ),
    }
    mc, mt, mv = model_stv_data(tracked, sce, axis=stv_axis)
    hc, ht, hvs = human_stv_data(humans, axis=stv_axis)
    allc = np.concatenate(mc + hc)
    allt = np.concatenate(mt + ht)
    cr, tr = (allc.min(), allc.max()), (allt.min(), allt.max())
    _, _, ms = build_stv_surface(mc, mt, mv, coord_range=cr, time_range=tr)
    _, _, hs = build_stv_surface(hc, ht, hvs, coord_range=cr, time_range=tr)
    out["surface_rmse_with_zeros"], _ = surface_rmse(ms, hs, True)
    out["surface_rmse_no_zeros"], _ = surface_rmse(ms, hs, False)
    plane, _ = spatiotemporal_plane_rmse(humans, tracked, sce)
    out["plane_centroid_rmse"] = plane
    out["n_tracked"] = len(tracked)
    out["n_human"] = len(humans)
    return out


def _git_sha() -> Optional[str]:
    """Framework git SHA for artifact provenance (best effort: None outside
    a git checkout or without git)."""
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                capture_output=True, text=True, timeout=10,
            ).stdout.strip()
            or None
        )
    except (OSError, subprocess.SubprocessError):
        return None


# Metric-specific caveats carried INSIDE every validation artifact, so the
# JSONs are self-contained (no reader should need PARITY.md to interpret a
# number that looks like a defect but is metric-inherent).
METRIC_CAVEATS = {
    "plane_centroid_rmse": (
        "plane_centroid_rmse is inherently large when a scenario's "
        "human-extraction and generation start masks offset the two point "
        "clouds (reference metric, Spatial_Distribution.py:1357-1429): the "
        "reference's own shipped sce4 GeneratedData scores 73.9 on it "
        "(live differential, tests/test_metrics.py::"
        "test_plane_rmse_differential_vs_live_reference).  Values in the "
        "tens here are metric-inherent, not a tracking defect; no "
        "published oracle exists for this metric."
    ),
}


def provenance(
    scenario, seed: int, mpc_cfg: Optional[MPCConfig] = None,
    n_csvs: Optional[int] = None, notes: Optional[List[str]] = None,
) -> Dict:
    """Self-describing provenance block embedded in every validation
    artifact (JAX ``pipeline.py:427``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    if mpc_cfg is None:
        mpc_cfg = default_mpc_cfg(sce)
    p = {
        "scenario": sce.key,
        "seed": seed,
        "grid_size_m": GRID_SIZE_M,
        "tracker": {
            "prediction_horizon": mpc_cfg.prediction_horizon,
            "control_horizon": mpc_cfg.control_horizon,
            "dt": mpc_cfg.dt,
        },
        "git_sha": _git_sha(),
        "notes": list(notes or []),
    }
    if n_csvs is not None:
        p["n_csvs"] = n_csvs
    p["notes"].extend(sce.provenance_notes)
    p["notes"].extend(METRIC_CAVEATS.values())
    return p


def run_scenario(
    checkpoint_dir: str,
    scenario: str,
    data_root: str,
    out_dir: str,
    seed: int = 0,
    device="cuda",
    timer=None,
) -> Dict[str, float]:
    """One-shot (JAX ``pipeline.py:588``): load the checkpoint onto
    ``device``, generate+track every scenario CSV, save the traces under
    ``<out_dir>/GeneratedData``, and validate.  Writes
    ``<out_dir>/validation_<sce>.json`` with an embedded provenance block
    (seed, grid, tracker config, git SHA); non-finite metrics are ``null``.
    ``timer`` is passed to :func:`generate_and_track`."""
    from .train.checkpoint import load_checkpoint, require_cvae_config

    sce = scenarios.get(scenario)
    params, cfg, manifest = load_checkpoint(checkpoint_dir, device)
    require_cvae_config(cfg, "run_scenario")
    csvs = collect_csv_files(os.path.join(data_root, sce.town))
    # legacy non-offset checkpoints decode ABSOLUTE [t,x,y] — their
    # manifests record offset_mode False and the generator must not shift
    # by the start point (same handling as generate.load_and_generate and
    # the serve CLI)
    traces, names = generate_and_track(
        params, cfg, sce, csvs, seed=seed,
        shift_start=manifest.get("offset_mode", True), timer=timer,
    )
    gen_dir = os.path.join(out_dir, "GeneratedData")
    # clear this scenario's stale traces first: a CSV whose draw stays
    # degenerate (or was removed) would otherwise leave an old-seed file
    # behind, and load_tracked consumers would silently score a mixed set
    if os.path.isdir(gen_dir):
        fresh = set(names)
        prefix = f"tracked_trajectory_{sce.key}_"
        for f in os.listdir(gen_dir):
            if f.startswith(prefix) and f.endswith(".npy") and f not in fresh:
                os.remove(os.path.join(gen_dir, f))
    save_tracked(traces, names, gen_dir)
    humans = load_humans(sce, csvs)
    report = validate(traces, humans, sce)
    report["provenance"] = provenance(sce, seed, n_csvs=len(csvs))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"validation_{sce.key}.json"), "w") as f:
        json.dump(jsonable(report), f, indent=2)
    return report


def reproduce_scoreboard(
    checkpoint_root: str,
    data_root: str,
    out_dir: str,
    scenario_keys: Optional[Sequence[str]] = None,
    seeds: Optional[Dict[str, int]] = None,
    check: bool = False,
    device="cuda",
) -> Dict[str, Dict]:
    """Regenerate every ``validation_<sce>.json`` and the scoreboard against
    the published-best values from the committed checkpoints in one process
    (JAX ``pipeline.py:457``).

    Each scenario's generation seed is the one recorded in its existing
    artifact's provenance block, so a plain rerun reproduces the committed
    numbers; ``seeds`` overrides.  A seed that cannot be read falls back to
    0 with a warning on stderr.

    Returns ``{sce: {"report": …, "board": {metric: {ours, published_best,
    beats}}}}`` and writes ``<out_dir>/scoreboard.json`` (a subset run
    refreshes only its own scenarios' blocks).

    ``check=True``: every numeric (or null, read as NaN) metric of the
    committed artifact except ``provenance``, snapshotted before the run
    overwrites it, is compared with its regenerated value at a relative
    1e-6; a deviation, a non-finite value on one side only, or a missing or
    unreadable artifact (``"__artifact__"``) lands under the scenario's
    ``"check_failures"``.  No baseline is a failure."""
    keys = list(scenario_keys or scenarios.REGISTRY)
    out: Dict[str, Dict] = {}
    for key in keys:
        # the committed artifact is both the check's baseline and the
        # source of the recorded seed: read it once, before the run
        committed, committed_err = None, None
        prev = os.path.join(out_dir, f"validation_{key}.json")
        try:
            with open(prev) as f:
                committed = json.load(f)
        except (OSError, ValueError) as e:
            committed_err = f"{type(e).__name__}: {e}"

        seed = (seeds or {}).get(key)
        if seed is None:
            seed = 0
            try:
                seed = int(committed["provenance"]["seed"])
            except (KeyError, TypeError, ValueError):
                print(
                    f"WARNING: could not read recorded seed from {prev} "
                    f"({committed_err or 'no provenance.seed'}); using seed 0 "
                    f"— results will NOT match the committed artifact",
                    file=sys.stderr,
                )
        report = run_scenario(os.path.join(checkpoint_root, key), key, data_root, out_dir,
                              seed=seed, device=device)
        out[key] = {
            "report": dict(report),
            "board": {
                m: {"ours": float(report[m]), "published_best": pub,
                    "beats": bool(report[m] < pub)}
                for m, pub in (scenarios.get(key).published_best or {}).items()
            },
        }
        if check:
            out[key]["check_failures"] = _check_failures(committed, committed_err, report)

    # subset runs refresh only their scenarios' blocks, preserving the rest
    board_path = os.path.join(out_dir, "scoreboard.json")
    board = {}
    if os.path.exists(board_path):
        try:
            with open(board_path) as f:
                board = json.load(f)
        except (OSError, ValueError):
            board = {}
    board.update({key: entry["board"] for key, entry in out.items()})
    with open(board_path, "w") as f:
        json.dump(jsonable(board), f, indent=2)
    return out


def _check_failures(committed, committed_err, report) -> Dict[str, Dict]:
    """The metrics of ``report`` that drifted from the committed artifact
    (:func:`reproduce_scoreboard`'s ``check``)."""
    if committed is None:
        return {"__artifact__": {
            "committed": None,
            "error": committed_err or "no committed artifact to check against"}}
    failures = {}
    # jsonable stores a non-finite metric as null: a committed null is a
    # metric too (NaN at commit time) and is compared as NaN
    for m, v in committed.items():
        if m == "provenance" or not (
                v is None or (isinstance(v, (int, float)) and not isinstance(v, bool))):
            continue
        old = float("nan") if v is None else float(v)
        new = report.get(m)
        new = float(new) if new is not None else float("nan")
        if np.isnan(old) and np.isnan(new):
            continue
        if not (np.isfinite(new) and np.isfinite(old)):
            failures[m] = {"committed": v, "regenerated": new}
        elif abs(new - old) > 1e-6 * max(1.0, abs(old)):
            failures[m] = {"committed": old, "regenerated": new}
    return failures
