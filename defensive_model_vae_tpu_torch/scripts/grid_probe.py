"""The seed grid on K2 against K1 launched once a seed: where a grid's
per-epoch time goes.

Port of the JAX package's ``scripts/grid_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.grid_probe \\
        [--seeds 32] [--epochs 3000] [--reps 4] [--out FILE]

The workload is the sce1 fixture (38 windows) trained under ``--seeds``
seeds for ``--epochs`` epochs.  Five variants, interleaved rep by rep (rep
0 untimed), each timed by CUDA events around its call:

  grid         K2 (``_fused_multi_call_padded``) over ``--seeds`` copies of
               the corpus, ``use_mask=False``: one launch, one cluster a seed
  grid_masked  the same with ``use_mask=True``: the ragged path.  No row is
               padded, so the mask keeps every row and the launch is the
               grid's own (the output says so, and the check holds it)
  grid_static  ``grid`` with ``_metrics="static"``: every epoch's metrics
               row to row 0, which isolates the metrics store's cost (the
               history is invalid; the params are ``grid``'s bit for bit)
  grid_s8      ``grid`` over a quarter of the seeds (8 of JAX's 32): does
               a seed's cost depend on how many share the card?
  single_x32   ``--seeds`` K1 launches through ``fused_call`` back to back,
               one synchronise at the end

Each rep draws a fresh base seed; every operand (the stacked initial
params, the corpus copies, the seeds) is made before the timed windows.
Each variant's cluster size (picked by occupancy per launch) stands beside
its time.  The checks run outside the timing: the histories of ``grid``,
``grid_masked`` and ``grid_s8`` finite and descending (below a fifth of
the first epoch's loss at the full 3000 epochs, JAX :182; below it at a
cut depth); ``grid_static``'s params bit for bit ``grid``'s on the same
operands and its row 0 ``grid``'s last row; ``grid_masked`` bit for bit
``grid``.  The result is printed as one JSON line and written to ``--out``
only when given.  Runs on the card unless ``--device cpu`` (the plain
versions; times then come from the host clock and are no device metric).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import scenarios
from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_trainer as ft
from ._timing import device_name, fresh_seed, timed

SEEDS, EPOCHS, REPS = 32, 3000, 4
# JAX's descent check (:182): at the full depth the last loss is below a
# fifth of the first
DESCENT_FACTOR = 5.0
VARIANTS = ("grid", "grid_masked", "grid_static", "grid_s8", "single_x32")


def load_windows() -> np.ndarray:
    """The sce1 fixture, as ``bench.py::_load_windows`` (:177) reads it."""
    return np.load(scenarios.get("sce1").fixture_windows)


def few_seeds(seeds: int) -> int:
    """grid_s8's seeds: a quarter of the grid's, as JAX's 8 of 32."""
    return max(1, seeds // 4)


def _stacked(seeds, cfg, dev):
    return ft.stack_flat_params([init_params(torch.Generator().manual_seed(s), cfg, dev)
                                 for s in seeds])


def grid_operands(x_flat, cond, seeds, cfg, dev):
    """The padded form of ``len(seeds)`` copies of one corpus: (stacked
    params, x (S, B, F), cond (S, B, C), an all-ones (S, B, 1) mask on the
    host, the seeds)."""
    S = len(seeds)
    x = x_flat.expand(S, -1, -1).contiguous()
    c = cond.expand(S, -1, -1).contiguous()
    return _stacked(seeds, cfg, dev), x, c, torch.ones((S, x_flat.shape[0], 1)), list(seeds)


class Probe:
    """Every rep's operands, made once, and one run of each variant."""

    def __init__(self, seeds, epochs, reps, dev):
        self.epochs, self.dev = epochs, dev
        windows = load_windows()
        self.cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
        self.lw = LossWeights()
        self.x_flat, self.cond = ft.fused_inputs(windows, dev)
        self.B = self.x_flat.shape[0]
        self.prep = []
        for _ in range(reps + 1):
            base = fresh_seed()
            self.prep.append({
                "grid": grid_operands(self.x_flat, self.cond, range(base, base + seeds),
                                      self.cfg, dev),
                "few": grid_operands(self.x_flat, self.cond,
                                     range(base + (1 << 14),
                                           base + (1 << 14) + few_seeds(seeds)),
                                     self.cfg, dev),
                "plist": ft._flatten_params(init_params(torch.Generator().manual_seed(base),
                                                        self.cfg, dev)),
                "seeds": list(range(base, base + seeds))})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, variant, rep):
        """One call of ``variant`` → (its outputs, the cluster size taken)."""
        p, common = self.prep[rep], (self.cfg, self.lw, self.epochs, 1e-3)
        if variant == "single_x32":
            outs = [ft.fused_call(p["plist"], self.x_flat, self.cond, s, *common)
                    for s in p["seeds"]]
            return outs, ft.fused_call.cluster
        stacked, x, c, mask, seeds = p["few" if variant == "grid_s8" else "grid"]
        out = ft._fused_multi_call_padded(stacked, x, c, mask, seeds, *common,
                                          use_mask=variant == "grid_masked",
                                          _metrics="static" if variant == "grid_static"
                                          else "full")
        return out, ft._fused_multi_call.cluster


def check(last, epochs):
    """The checks outside the timing (module docstring) → their record."""
    factor = DESCENT_FACTOR if epochs >= EPOCHS else 1.0
    losses = {}
    for v in ("grid", "grid_masked", "grid_s8"):
        m = last[v][1][:, :, 0]
        first, fin = m[:, 0], m[:, epochs - 1]
        if not (torch.isfinite(m).all() and (fin < first / factor).all()):
            raise SystemExit(f"grid_probe: {v} did not descend below 1/{factor:g} of its "
                             f"first loss: {first.tolist()} -> {fin.tolist()}")
        losses[v] = [float(first.max()), float(fin.max())]
    (pg, mg), (ps, ms) = last["grid"], last["grid_static"]
    static_same = all(torch.equal(a, b) for a, b in zip(pg, ps))
    static_row = torch.equal(ms[:, 0], mg[:, -1])
    if not (static_same and static_row):
        raise SystemExit("grid_probe: grid_static's params or row 0 are not grid's")
    pm, mm = last["grid_masked"]
    masked_same = all(torch.equal(a, b) for a, b in zip(pg, pm)) and torch.equal(mg, mm)
    if not masked_same:
        raise SystemExit("grid_probe: grid_masked differs from grid with no row padded")
    return {"descent_factor": factor, "loss_first_last_max": losses,
            "static_params_bit_for_bit_grid": static_same,
            "static_row0_is_grid_last_row": static_row,
            "masked_bit_for_bit_grid": masked_same}


def run_probe(seeds=SEEDS, epochs=EPOCHS, reps=REPS, dev=None, log=None):
    """The probe → its result dict (module docstring)."""
    probe = Probe(seeds, epochs, reps, dev)
    times = {v: [] for v in VARIANTS}
    clusters, last = {}, {}
    for rep in range(reps + 1):
        for v in VARIANTS:
            dt, (out, cluster) = timed(lambda: probe.run(v, rep), dev)
            clusters[v] = cluster
            if rep == reps:
                last[v] = out
            if rep:
                times[v].append(dt)
            if log:
                print(f"{'cold' if rep == 0 else f'rep{rep}'} {v}: {dt:.4f}s", file=log)
    # the launches' outputs are on the device: the checks fetch them here,
    # after every timed window
    last = {v: o for v, o in last.items() if v != "single_x32"}
    last = {v: (tuple(a.cpu() for a in p), m.cpu()) for v, (p, m) in last.items()}
    out = {"seeds": seeds, "few_seeds": few_seeds(seeds), "epochs": epochs, "reps": reps,
           "B": probe.B, "device": device_name(dev),
           "grid_masked_note": "no row is padded, so use_mask=True keeps every row: "
                               "grid_masked is grid's launch, bit for bit",
           "checks": check(last, epochs), "variants": {}}
    for v in VARIANTS:
        n = few_seeds(seeds) if v == "grid_s8" else seeds
        best = min(times[v])
        out["variants"][v] = {"best_s": best, "all_s": times[v],
                              "us_per_epoch_seed": best / (epochs * n) * 1e6,
                              "seeds": n, "cluster": clusters[v]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=SEEDS)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--reps", type=int, default=REPS, help="timed reps after one untimed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    if min(args.seeds, args.epochs, args.reps) < 1:
        raise SystemExit("--seeds, --epochs and --reps must be at least 1")
    dev = resolve_device(args.device)
    out = run_probe(args.seeds, args.epochs, args.reps, dev, log=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"grid_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
