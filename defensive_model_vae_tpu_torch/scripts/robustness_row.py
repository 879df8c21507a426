"""The selection-free robustness row of the scoreboard, from the committed
train-seed sweeps.

Port of the JAX package's ``scripts/robustness_row.py``:

    python -m defensive_model_vae_tpu_torch.scripts.robustness_row [--out FILE]

The scoreboard reports the selected train-seed checkpoint.  This row is
the view without selection: for each scenario and metric, the median
train seed's mean metric over the committed sweep (``results/
seed_sweep_*.json``) and how many train seeds beat the published value.
The rows of each scenario come from the recipe its shipped checkpoint
used:

- sce1: ``seed_sweep_sce1_a`` and ``_b`` merged, one row a train seed
  (the same recipe, so an overlapping seed is the same run);
- sce2, sce3: their sweeps;
- sce4: ``seed_sweep_sce4_recipe`` filtered to the recipe in
  ``results/checkpoints/sce4/manifest.json`` (epochs, lr, kld weight,
  point mode).

A sweep's means are over its 3 selection generation seeds (5, 6, 8):
noisy estimates of each train seed's mean, enough for a median across
8-110 seeds.  Host only: every number is in the committed files, which
this script reads and never writes.  The row is printed as one JSON line
(the markdown table goes to stderr) and written to ``--out`` only when
given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"

METRICS = (
    "velocity_js_divergence",
    "rmse_frequency_trajcount",
    "surface_rmse_with_zeros",
    "surface_rmse_no_zeros",
)
SHORT = {
    "velocity_js_divergence": "JS divergence",
    "rmse_frequency_trajcount": "RMSE_frequency (trajcount)",
    "surface_rmse_with_zeros": "Surface RMSE (incl. zeros)",
    "surface_rmse_no_zeros": "Surface RMSE (excl. zeros)",
}
NOTE = (
    "Selection-free robustness: per cell, the MEDIAN train seed's "
    "mean metric across the committed sweep (means over selection "
    "gen seeds 5/6/8 — 3-sample estimates, not the n=70 reporting "
    "band), and the fraction of train seeds whose mean beats the "
    "published value.  Complements the selected-checkpoint "
    "scoreboard: cells with median_beats=true are won by the "
    "method without any train-seed selection."
)


def _load(name, results=RESULTS):
    with open(results / f"seed_sweep_{name}.json") as f:
        return json.load(f)


def _sce1_rows(results):
    a, b = _load("sce1_a", results), _load("sce1_b", results)
    by_seed = {}
    for r in a["ranked"] + b["ranked"]:
        by_seed.setdefault(r["train_seed"], r)
    return list(by_seed.values()), a["published_best"], "sce1_a + sce1_b merged"


def _sweep_rows(name, results):
    d = _load(name, results)
    return d["ranked"], d["published_best"], f"{name} sweep"


def _sce4_rows(results):
    with open(results / "checkpoints" / "sce4" / "manifest.json") as f:
        recipe = json.load(f)["recipe"]
    d = _load("sce4_recipe", results)
    key = ("epochs", "lr", "kld_weight", "point_mode")
    rows = [r for r in d["ranked"] if tuple(r[k] for k in key) == tuple(recipe[k] for k in key)]
    src = (f"sce4_recipe filtered to shipped recipe (epochs="
           f"{recipe['epochs']}, lr={recipe['lr']}, kld="
           f"{recipe['kld_weight']}, {recipe['point_mode']})")
    return rows, d["published_best"], src


def build(results=RESULTS):
    """The row → {"note", "scenarios": {sce: {"source", "n_rows", "cells"}}}."""
    sources = {"sce1": lambda: _sce1_rows(results),
               "sce2": lambda: _sweep_rows("sce2", results),
               "sce3": lambda: _sweep_rows("sce3", results),
               "sce4": lambda: _sce4_rows(results)}
    out = {"note": NOTE, "scenarios": {}}
    for sce, rows_of in sources.items():
        rows, pub, src = rows_of()
        cells = {}
        for m in METRICS:
            # a metric present, and not NaN (NaN != NaN)
            vals = [r["means"][m] for r in rows
                    if r.get("means") and r["means"].get(m) is not None
                    and r["means"][m] == r["means"][m]]
            med = statistics.median(vals)
            cells[m] = {"median": med, "published": pub[m], "median_beats": med < pub[m],
                        "seeds_beating": sum(1 for v in vals if v < pub[m]),
                        "n_seeds": len(vals)}
        out["scenarios"][sce] = {"source": src, "n_rows": len(rows), "cells": cells}
    return out


def table(out) -> str:
    """The row as the scoreboard's markdown table."""
    lines = ["| Metric (median train seed / published; seeds beating) "
             "| sce1 | sce2 | sce3 | sce4 |", "|---|---|---|---|---|"]
    for m in METRICS:
        cols = []
        for sce in ("sce1", "sce2", "sce3", "sce4"):
            c = out["scenarios"][sce]["cells"][m]
            v = f"{c['median']:.3f}"
            v = f"**{v}**" if c["median_beats"] else v
            cols.append(f"{v} / {c['published']:.3f} ({c['seeds_beating']}/{c['n_seeds']})")
        lines.append(f"| {SHORT[m]} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the row here (JSON)")
    args = ap.parse_args(argv)
    out = build()
    n_beat = sum(c["median_beats"] for s in out["scenarios"].values()
                 for c in s["cells"].values())
    print(table(out), file=sys.stderr)
    print(f"median-train-seed cells beating published: {n_beat}/16", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"robustness_row": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
