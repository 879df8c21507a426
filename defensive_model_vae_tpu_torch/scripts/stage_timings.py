"""Stage times of the warm production loop, in one process.

Port of the JAX package's ``scripts/stage_timings.py``:

    python -m defensive_model_vae_tpu_torch.scripts.stage_timings \\
        --data-root DIR --sut-dir DIR [--scenarios sce2] [--epochs 300] [--out FILE]

Stages (``utils.StageTimer``, which synchronises the card at each stage's
start and end, so a stage's seconds hold the device work it queued):

- ``pipeline_<sce>``: generate → track → validate from the committed
  checkpoint over the scenario's episodes (``run_scenario`` without its
  artifact writes), with the sub-stages ``<sce>_conditions``,
  ``<sce>_generate``, ``<sce>_track`` and ``<sce>_validate``;
- ``multi_kernel_train_4x<epochs>``: the four scenarios' models trained in
  one launch of kernel K2 (``fused_train_multi`` on the committed fixtures);
- ``dnda_sweep_<n>_episodes``: ``score_directory`` over the ``n`` SUT
  episodes of ``--sut-dir``.

Each stage runs once untimed, then once timed, each with an entropy seed
(``fresh_seed``); the DNDA stage warms on a copy of the corpus with the
vehicles' velocities jittered by 1e-3 and times one jittered by a fresh
eps (``jittered_sut_copy``), so the timed run's inputs are new.  A missing
tree or SUT directory is an error naming it.  On episode trees written from
the committed windows (``scripts/episodes.py``) the times are those of that
data.  The report is printed as one JSON line and written to ``--out``
only when given.  Runs on the card unless ``--device cpu`` (host-clock
times of the plain versions there, no device figure).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from .. import scenarios
from .._device import resolve_device
from ..data import collect_csv_files
from ..dnda import score_directory
from ..ops import fused_train_multi
from ..pipeline import generate_and_track, load_humans, validate
from ..train import load_checkpoint
from ..utils import StageTimer
from ._timing import fresh_seed, jittered_sut_copy


def run(keys, data_root, sut_dir, ckpt_root="results/checkpoints", epochs=300, dev=None,
        processes=None):
    """The three stages → ``StageTimer.report()``."""
    trees = {k: os.path.join(data_root, scenarios.get(k).town) for k in keys}
    for path in [*trees.values(), sut_dir]:
        if not os.path.isdir(path):
            raise SystemExit(f"stage_timings: no such directory: {path}")
    timer = StageTimer(dev)
    for key in keys:
        sce = scenarios.get(key)
        params, cfg, _ = load_checkpoint(os.path.join(ckpt_root, key), dev)
        csvs = collect_csv_files(trees[key])
        humans = load_humans(sce, csvs)
        generate_and_track(params, cfg, sce, csvs, seed=fresh_seed())
        with timer.stage(f"pipeline_{key}"):
            traces, _ = generate_and_track(params, cfg, sce, csvs, seed=fresh_seed(),
                                           timer=timer)
            with timer.stage(f"{key}_validate"):
                validate(traces, humans, sce)

    corpora = {k: np.load(scenarios.get(k).fixture_windows) for k in scenarios.REGISTRY}
    fused_train_multi(corpora, epochs=epochs, seed=fresh_seed(), device=dev)
    with timer.stage(f"multi_kernel_train_{len(corpora)}x{epochs}"):
        fused_train_multi(corpora, epochs=epochs, seed=fresh_seed(), device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        warm, timed = os.path.join(tmp, "warm"), os.path.join(tmp, "timed")
        jittered_sut_copy(sut_dir, warm)
        n = len(score_directory(warm, device=dev, processes=processes))
        jittered_sut_copy(sut_dir, timed, eps=2e-3 + 1e-12 * fresh_seed())
        with timer.stage(f"dnda_sweep_{n}_episodes"):
            score_directory(timed, device=dev, processes=processes)
    return timer.report()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default="DefensiveData")
    ap.add_argument("--sut-dir", default="SUT_Testing/collected_data")
    ap.add_argument("--ckpt-root", default="results/checkpoints")
    ap.add_argument("--scenarios", default=",".join(scenarios.REGISTRY),
                    help="the pipeline stages' scenarios (default all four)")
    ap.add_argument("--epochs", type=int, default=300,
                    help="K2's epochs in the multi-scenario stage")
    ap.add_argument("--processes", type=int, default=None,
                    help="the DNDA stage's host-preparation workers (default one a core)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.scenarios.split(","), args.data_root, args.sut_dir, args.ckpt_root,
                 args.epochs, resolve_device(args.device), args.processes)
    for name, row in report.items():
        print(f"{name}: {row['seconds']:.2f}s", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({"stage_timings": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
