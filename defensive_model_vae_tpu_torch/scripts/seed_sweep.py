"""Train-seed selection sweep.

Port of the JAX package's ``scripts/seed_sweep.py``:

    python -m defensive_model_vae_tpu_torch.scripts.seed_sweep --scenario sce4 \\
        --train-seeds 0:128 --select-gen-seeds 5,6,8 --data-root DIR [--out FILE]

For each candidate (train seed × ``--epochs`` × ``--lr`` × ``--kld`` ×
``--point-mode``): train the scenario CVAE with ``train.train``, the scan
trainer, as the committed checkpoints were trained (a selected seed
transfers only if the final checkpoint reuses the candidate's noise
stream), then run generate → track → validate on the SELECTION generation
seeds, all of them in one tracking batch (``pipeline.generate_and_track_multi``;
``--track-chunk N`` splits them into N-seed batches).  The selection seeds
are kept apart from the reporting band of ``multiseed_validate`` so that
reported bands stay unselected.

Scoring (:func:`score_candidate`, :func:`rank_candidates`): the number of
published-best metrics the selection-seed mean beats, tie-broken maximin:
the widest worst-case relative margin over the four metrics wins, and a
non-finite mean ranks the candidate last.  ``extend_mid`` is the
reference's midpoint-augmented corpus, built from ``--data-root``;
``normal`` is ``--windows`` (default the committed fixture).
``--band-eval-top K`` trains the top K again and evaluates them on the
unselected reporting band (``--band-gen-seeds``), recording each metric's
``band_stats``.

The episodes under ``--data-root`` supply the start points and the human
tracks; on trees written from the committed windows
(``scripts/episodes.py``) the scores describe that data, not the human
logs.  A missing tree is an error naming it.  Progress goes to stderr; the
document (JAX's keys) is printed as one JSON line and written to ``--out``
only when given.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .. import scenarios
from .._device import resolve_device
from ..data import build_dataset, collect_csv_files
from ..models import CVAEConfig, LossWeights
from ..pipeline import generate_and_track_multi, load_humans, validate
from ..train import TrainConfig, train
from ..utils import band_stats, jsonable
from .multiseed_validate import DEFAULT_GEN_SEEDS

# the published-best values per scenario live in the scenario registry
# (Scenario.published_best, cited to results/ModelValidation/JS_divergence.txt)
METRICS = [
    "velocity_js_divergence", "rmse_frequency_trajcount",
    "surface_rmse_with_zeros", "surface_rmse_no_zeros",
]


def parse_seed_spec(spec: str) -> list[int]:
    """'0:70' / '59:110,29,13' → explicit seed list (ranges are half-open)."""
    seeds: list[int] = []
    for part in str(spec).split(","):
        if ":" in part:
            lo, hi = (int(v) for v in part.split(":"))
            seeds.extend(range(lo, hi))
        else:
            seeds.append(int(part))
    return seeds


def score_candidate(means: dict, pub: dict) -> tuple[int, float]:
    """(beats_published, worst relative margin) for one candidate.

    Maximin selection: the binding (smallest-margin) metric decides.
    Builtin ``min()`` silently skips non-first NaNs, so any non-finite mean
    ranks the candidate LAST (-inf), never by an optimistic partial margin.
    A null mean (``jsonable``'s non-finite) is read as NaN."""
    vals = {m: (float("nan") if means[m] is None else means[m]) for m in METRICS}
    beaten = sum(vals[m] < pub[m] for m in METRICS)
    margins = [(pub[m] - vals[m]) / pub[m] for m in METRICS]
    worst = min(margins) if all(np.isfinite(v) for v in margins) else float("-inf")
    return beaten, worst


def rank_candidates(results: list[dict]) -> list[dict]:
    """Sort best-first: most published cells beaten, then widest worst margin."""
    return sorted(results, key=lambda r: (-r["beats_published"], -r["worst_margin"]))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def sweep(scenario, train_seeds, select_gen_seeds, epochs=(3000,), lrs=(1e-3,),
          klds=(0.1,), point_modes=("normal",), band_eval_top=0, band_gen_seeds=(),
          track_chunk=0, data_root="DefensiveData", windows=None, dev=None):
    """The sweep → the output document (module docstring; JAX's keys)."""
    sce = scenarios.get(scenario)
    pub = sce.published_best
    tree = os.path.join(data_root, sce.town)
    if not os.path.isdir(tree):
        raise SystemExit(f"seed_sweep: no episode tree for {sce.key} at {tree}")
    corpora = {}
    for mode in point_modes:
        if mode == "normal":
            corpora[mode] = np.load(windows or sce.fixture_windows)
        else:
            corpora[mode] = build_dataset(data_root, sce.key, point_mode=mode)
            _log(f"built {mode} corpus: {corpora[mode].shape}")
    csvs = collect_csv_files(tree)
    humans = load_humans(sce, csvs)
    first = next(iter(corpora.values()))
    cfg = CVAEConfig(seq_len=first.shape[1], dim=first.shape[2])
    gens = list(select_gen_seeds)

    def train_candidate(mode, lr, kld, n_epochs, ts):
        tc = TrainConfig(epochs=n_epochs, lr=lr, seed=ts, weights=LossWeights(kld=kld))
        return train(corpora[mode], train_cfg=tc, device=dev)

    def eval_candidate(params, gen_seeds):
        chunk = track_chunk or len(gen_seeds)
        per_gen = {}
        for i in range(0, len(gen_seeds), chunk):
            part = gen_seeds[i:i + chunk]
            tracked = generate_and_track_multi(params, cfg, sce, csvs, seeds=part)
            for g in part:
                rep = validate(tracked[g][0], humans, sce)
                per_gen[g] = {m: rep[m] for m in METRICS}
        return per_gen

    results = []
    grid = [(mode, lr, kld, e, s) for mode in corpora for lr in lrs for kld in klds
            for e in epochs for s in train_seeds]
    for mode, lr, kld, n_epochs, ts in grid:
        t0 = time.perf_counter()
        params, hist = train_candidate(mode, lr, kld, n_epochs, ts)
        per_gen = eval_candidate(params, gens)
        means = {m: float(np.mean([per_gen[g][m] for g in gens])) for m in METRICS}
        beaten, worst_margin = score_candidate(means, pub)
        results.append({
            "train_seed": ts, "epochs": n_epochs, "lr": lr, "kld_weight": kld,
            "point_mode": mode, "final_loss": float(hist["total"][-1]),
            "means": means, "per_gen": per_gen, "beats_published": beaten,
            "worst_margin": worst_margin,
        })
        _log(f"{mode} lr{lr:g} kld{kld:g} seed {ts:3d} ep{n_epochs}: beats {beaten}/4  "
             + "  ".join(f"{m.split('_')[-1]}={means[m]:.4f}" for m in METRICS)
             + f"  ({time.perf_counter() - t0:.1f}s)")

    results = rank_candidates(results)
    best = results[0]
    _log(f"BEST candidate {best['point_mode']} lr{best['lr']:g} kld{best['kld_weight']:g} "
         f"seed {best['train_seed']}: beats {best['beats_published']}/4, worst margin "
         f"{best['worst_margin']:+.3f}")
    doc = {
        "scenario": sce.key, "train_seeds": list(train_seeds), "select_gen_seeds": gens,
        "epochs": list(epochs), "lr": list(lrs), "kld": list(klds),
        "point_mode": sorted(corpora), "published_best": pub, "ranked": results,
    }
    if band_eval_top > 0:
        band_seeds = list(band_gen_seeds)
        band_eval = []
        for cand in results[:band_eval_top]:
            params, _ = train_candidate(cand["point_mode"], cand["lr"], cand["kld_weight"],
                                        cand["epochs"], cand["train_seed"])
            t0 = time.perf_counter()
            per_gen = eval_candidate(params, band_seeds)
            stats = {m: band_stats([per_gen[g][m] for g in band_seeds]) for m in METRICS}
            band_eval.append({k: cand[k] for k in ("train_seed", "epochs", "lr", "kld_weight",
                                                   "point_mode")} | {"band": stats})
            _log(f"band[{cand['point_mode']} seed {cand['train_seed']}] "
                 + "  ".join(f"{m.split('_')[-1]}={stats[m]['mean']:.4f}" for m in METRICS)
                 + f"  ({time.perf_counter() - t0:.1f}s)")
        doc["band_gen_seeds"] = band_seeds
        doc["band_eval"] = band_eval
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", required=True)
    ap.add_argument("--train-seeds", default="0:70",
                    help="comma-separated start:stop ranges and/or single seeds")
    ap.add_argument("--select-gen-seeds", default="5,6,8")
    ap.add_argument("--epochs", default="3000",
                    help="comma-separated epoch counts; each (epochs, seed) pair is a candidate")
    ap.add_argument("--lr", default="1e-3", help="comma-separated learning rates")
    ap.add_argument("--kld", default="0.1", help="comma-separated KLD loss weights")
    ap.add_argument("--point-mode", default="normal",
                    help="comma-separated corpus modes: normal (--windows) and/or "
                         "extend_mid (midpoint-augmented, built from --data-root)")
    ap.add_argument("--band-eval-top", type=int, default=0,
                    help="train the top-K ranked candidates again and evaluate them on "
                         "the reporting band (disclosed shortlist)")
    ap.add_argument("--band-gen-seeds", default=DEFAULT_GEN_SEEDS,
                    help="reporting-band gen seeds for --band-eval-top (default the "
                         "n=70 unselected band)")
    ap.add_argument("--track-chunk", type=int, default=0,
                    help="gen seeds per tracking batch (0 = all in one)")
    ap.add_argument("--data-root", default="DefensiveData")
    ap.add_argument("--windows", default=None,
                    help="windows npy (default fixtures/trajectory_<sce>_cond.npy)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the document here (JSON)")
    args = ap.parse_args(argv)
    doc = sweep(args.scenario, parse_seed_spec(args.train_seeds),
                [int(v) for v in args.select_gen_seeds.split(",")],
                [int(v) for v in args.epochs.split(",")],
                [float(v) for v in args.lr.split(",")],
                [float(v) for v in args.kld.split(",")], args.point_mode.split(","),
                args.band_eval_top, [int(v) for v in args.band_gen_seeds.split(",")],
                args.track_chunk, args.data_root, args.windows,
                resolve_device(args.device))
    doc = jsonable(doc)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    print(json.dumps({"seed_sweep": doc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
