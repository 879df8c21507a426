"""Condition-feature builders for the conditioned CVAE variants.

Port of ``defensive_model_vae_tpu/data/features.py``; its windows come
from the port's own extraction, so ``train.train_conditioned`` takes its
extra columns from the port.

BASELINE config 4 ("Conditional VAE conditioned on scenario class +
THW/spatial-distribution features"): extends the reference's start-point
condition with a scenario one-hot and the window's trigger time-headway,
enabling ONE model over the combined four-scenario corpus.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import scenarios


def window_start_speed(window: np.ndarray) -> float:
    """Start speed of one [t, x, y] window from its first segment."""
    dt = window[1, 0] - window[0, 0]
    d = np.hypot(window[1, 1] - window[0, 1], window[1, 2] - window[0, 2])
    return float(d / dt) if dt > 0 else 0.0


def window_thw(
    window: np.ndarray,
    scenario,
    trial_suffix: str = "",
    default_distance: Optional[float] = None,
) -> float:
    """Trigger THW = scenario distance / start speed (``Get_THW.py:66-104``).

    Note the divergence from the cited reference: the reference takes the
    INSTANTANEOUS speed sqrt(vx²+vy²) at the trigger row, while here the
    speed is the chord-average over the window's first subsampled segment
    (the window arrays are all the conditioned corpus carries).  During a
    braking maneuver the chord average sits below the trigger-row speed,
    so these THWs skew slightly high vs reference THW distributions —
    self-consistent as a conditioning feature, not comparable 1:1.

    The distance comes from the scenario registry; a scenario without one
    (sce2 — the reference's Get_THW has no branch for it) uses
    ``default_distance`` when given, else fails loudly.  The default is a
    CROSS-scenario constant owned by the conditioned-corpus builder, not
    a registry entry — registering it would wrongly activate the
    reference-mirroring ``defvae thw`` output for sce2."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    v = window_start_speed(window)
    if sce.thw_distance is not None:
        d = sce.thw_distance
    elif sce.thw_distance_by_suffix is not None:
        d = sce.thw_distance_by_suffix.get(
            trial_suffix, sce.thw_distance_by_suffix["default"]
        )
    elif default_distance is not None:
        d = default_distance
    else:
        raise ValueError(
            f"{sce.key}: no THW distance registered (set thw_distance or "
            "thw_distance_by_suffix in scenarios.py, or pass "
            "default_distance)"
        )
    return d / v if v > 0 else 0.0


def window_trial_suffixes(
    data_root: str,
    scenario,
    target_points: int = 10,
    point_mode: str = "normal",
    dataset_variant: str = "shipped",
) -> List[str]:
    """Per-window trial suffixes, row-aligned with ``build_dataset``'s
    output for the SAME corpus parameters.  Needed because sce4's THW
    distance depends on the source trial suffix (``Get_THW.py:72-82``) and
    the window arrays carry no file provenance.

    Alignment holds by construction: this consumes the same
    ``windows.iter_windows`` walker ``build_dataset`` does, and for
    ``extend_mid`` (which appends the midpoint-augmented corpus after the
    normal one — the same file yields a window in both modes or neither,
    the emission check being mode-independent) the suffix list is the
    normal list twice."""
    from .windows import iter_windows

    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario

    def _suffixes(mode):
        return [
            fname.rsplit(".", 1)[0].rsplit("_", 1)[-1]
            for fname, _ in iter_windows(
                data_root, sce, target_points=target_points,
                point_mode=mode, dataset_variant=dataset_variant,
            )
        ]

    if point_mode == "extend_mid":
        # the emission check is mode-independent (same files yield a
        # window in both modes), so the appended corpus's suffixes are
        # the normal list again — no second corpus walk needed
        s = _suffixes("normal")
        return s + s
    return _suffixes(point_mode)


def build_conditioned_corpus(
    windows_by_scenario: Dict[str, np.ndarray],
    suffixes_by_scenario: Optional[Dict[str, Sequence[str]]] = None,
    default_thw_distance: float = 60.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack all scenario corpora with [one-hot, THW] extra conditions.

    Returns (windows (N, T, D), extra_cond (N, n_scenarios+1)) ready for
    ``train.train_conditioned``.  ``suffixes_by_scenario`` supplies the
    per-window trial suffixes (:func:`window_trial_suffixes`) so sce4's
    suffix-dependent THW distance (40 m for trial '3', else 30 m) is
    honored; without them every window uses the scenario default.
    ``default_thw_distance`` covers scenarios with no reference THW
    branch (sce2) — a conditioned-corpus convention, not a registry
    constant (see :func:`window_thw`).
    """
    keys = sorted(windows_by_scenario.keys())
    n_sce = len(scenarios.REGISTRY)  # one-hot width from the registry
    all_w, all_c = [], []
    for key in keys:
        sce = scenarios.get(key)
        w = np.asarray(windows_by_scenario[key], np.float32)
        suffixes = (suffixes_by_scenario or {}).get(key)
        onehot = np.zeros(n_sce, np.float32)
        onehot[sce.index - 1] = 1.0
        for i, win in enumerate(w):
            suffix = suffixes[i] if suffixes is not None else ""
            thw = window_thw(win, sce, suffix,
                             default_distance=default_thw_distance)
            all_w.append(win)
            all_c.append(np.concatenate([onehot, [thw]]))
    return np.stack(all_w), np.stack(all_c).astype(np.float32)
