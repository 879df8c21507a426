"""The device half of the pipeline: sample → track.

Port of the parts of ``defensive_model_vae_tpu/pipeline.py`` this slice
runs: ``default_mpc_cfg`` (:58), ``_valid_waypoint_times`` (:79),
``_draw_valid_samples`` (:181, with its ``seed + 1000·retry`` re-draw fold)
and the device halves of ``generate_and_track`` (:150-178) and
``generate_and_track_multi`` (:212-299) as
:func:`generate_and_track_from_starts` and
:func:`generate_and_track_multi_from_starts`.  The CSV half (start conditions
read from the human logs) comes with the ``data/`` slice; until then the
start points and initial states come from the fixture windows
(:func:`fixture_starts`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .control import MPCConfig, track_batch
from .generate import generate_trajectories
from .models import CVAEConfig


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
