"""The SUT corpus sweep's time taken apart into its three stages.

Port of the JAX package's ``scripts/dnda_drift_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.dnda_drift_probe \\
        --sut-dir DIR [--reps 4] [--out FILE]

``dnda.score_directory`` has three stages (``dnda/calculator.py``):

  prep     per-episode host work: CSV read, frame rotation, Frenet
           resampling, path clusters (numpy and the g++-built spline);
  sweep    the batched SAT collision sweep (``sweep_frames``, one torch
           program on the card) with its host padding and packing;
  finalize DA/RL per frame from the fetched collision indices (numpy).

:func:`staged_sweep` runs them as ``score_directory`` does, preparation
inline, with a timer on each, on copies of the corpus whose vehicles'
velocities are jittered by a fresh eps (``jittered_sut_copy``: warm on one
copy, time the others); each rep also times one ``score_directory`` call
(host preparation in its pool, ``--processes``) on the same copy, and the
host context (CPU count, load average) is recorded, since the host stages
scale with it.  ``sweep_frames`` returns numpy arrays, so the sweep's time ends with
the device's work fetched.

A missing ``--sut-dir`` prints a line naming it and returns, as JAX's
script does for its corpus.  The result is printed as one JSON line and
written to ``--out`` only when given.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

from .. import scenarios
from .._device import resolve_device
from ..dnda.calculator import _EPISODE_RE, _finalize_episode, prepare_episode, score_directory
from ..dnda.core import sweep_frames
from ._timing import fresh_seed, jittered_sut_copy

REPS = 4


def staged_sweep(directory, device="cuda", **episode_kwargs):
    """``score_directory``'s card path (``dnda/calculator.py:167``) with a
    timer on each stage, preparation inline → (prep s, sweep s, finalize s,
    frames swept, each episode's max DNDA in ``score_directory``'s row
    order)."""
    t0 = time.perf_counter()
    jobs = []
    for p in sorted(Path(directory).rglob("*.csv")):
        m = _EPISODE_RE.match(p.name)
        if not m:
            continue
        try:
            sce = scenarios.get(m.group("scenario"))
        except KeyError:
            continue
        jobs.append((str(p), sce.key))
    prepped = [(path, *prepare_episode(path, key, **episode_kwargs)) for path, key in jobs]
    t_prep = time.perf_counter() - t0

    t0 = time.perf_counter()
    all_preps = [p for _, _, preps in prepped for p in preps]
    all_cis = sweep_frames(all_preps, device=device)
    t_sweep = time.perf_counter() - t0

    t0 = time.perf_counter()
    maxes, k = [], 0
    for _, frames, preps in prepped:
        maxes.append(_finalize_episode(frames, preps, all_cis[k:k + len(preps)]).max_dnda)
        k += len(preps)
    t_final = time.perf_counter() - t0
    return t_prep, t_sweep, t_final, len(all_preps), maxes


def _smoke(tmp_dir, device="cuda", **episode_kwargs):
    """``staged_sweep`` re-implements ``score_directory``'s stages only to
    time them, so its maxima must be ``score_directory``'s episode for
    episode (equal: the same functions on the same frames) → frames swept."""
    rows = score_directory(tmp_dir, device=device, processes=1, **episode_kwargs)
    *_, n, maxes = staged_sweep(tmp_dir, device, **episode_kwargs)
    if [r["max_dnda"] for r in rows] != maxes:
        raise AssertionError(f"staged_sweep's maxima {maxes} differ from score_directory's "
                             f"rows {rows}")
    return n


def probe(sut_dir, reps=REPS, dev=None, processes=None, **episode_kwargs):
    """Warm on one jittered copy, then ``reps`` timed copies → the result.
    ``processes``: ``score_directory``'s pool (default one worker a core)."""
    out = {"cpu_count": os.cpu_count(), "loadavg_start": list(os.getloadavg()),
           "reps": [], "score_directory_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        warm_dir = os.path.join(tmp, "warm")
        jittered_sut_copy(sut_dir, warm_dir)
        warm = staged_sweep(warm_dir, dev, **episode_kwargs)
        out["warm_stages_s"] = [round(v, 3) for v in warm[:3]]
        print(f"warm: prep {warm[0]:.2f}s sweep {warm[1]:.2f}s final {warm[2]:.2f}s "
              f"({warm[3]} frames)", file=sys.stderr)
        for rep in range(reps):
            d = os.path.join(tmp, f"rep{rep}")
            jittered_sut_copy(sut_dir, d, eps=2e-3 + 1e-12 * fresh_seed())
            t_prep, t_sweep, t_final, n_frames, maxes = staged_sweep(d, dev, **episode_kwargs)
            # the jitter moves only the vehicles' velocities: the episodes
            # and their frames are the warm copy's
            if len(maxes) != len(warm[4]) or n_frames != warm[3]:
                raise RuntimeError(f"rep {rep} scored {len(maxes)} episodes and {n_frames} "
                                   f"frames against the warm copy's {len(warm[4])} and "
                                   f"{warm[3]}")
            total = t_prep + t_sweep + t_final
            out["reps"].append({"prep_s": round(t_prep, 3), "sweep_s": round(t_sweep, 3),
                                "finalize_s": round(t_final, 3), "total_s": round(total, 3),
                                "n_frames": n_frames})
            print(f"rep{rep}: prep {t_prep:.2f}s sweep {t_sweep:.2f}s final {t_final:.2f}s "
                  f"total {total:.2f}s", file=sys.stderr)
            t0 = time.perf_counter()
            score_directory(d, device=dev, processes=processes, **episode_kwargs)
            out["score_directory_s"].append(round(time.perf_counter() - t0, 3))
    out["loadavg_end"] = list(os.getloadavg())
    med = {k: statistics.median(r[k] for r in out["reps"])
           for k in ("prep_s", "sweep_s", "finalize_s")}
    out["summary"] = {
        "prep_median_s": round(med["prep_s"], 3),
        "sweep_median_s": round(med["sweep_s"], 3),
        "finalize_median_s": round(med["finalize_s"], 3),
        "score_directory_median_s": round(statistics.median(out["score_directory_s"]), 3),
        "host_share_pct": round(100 * (med["prep_s"] + med["finalize_s"])
                                / sum(med.values()), 1),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sut-dir", default="SUT_Testing/collected_data")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--processes", type=int, default=None,
                    help="score_directory's host-preparation workers (default one a core)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    if args.reps < 1:
        raise SystemExit("--reps must be at least 1")
    if not os.path.isdir(args.sut_dir):
        print(f"SUT corpus absent ({args.sut_dir}); nothing to probe", file=sys.stderr)
        return 0
    out = probe(args.sut_dir, args.reps, resolve_device(args.device), args.processes)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"dnda_drift_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
