"""BASELINE.json's configurations on the repository's fixtures, as one
report.

Port of the JAX package's ``scripts/run_baseline_configs.py``:

    python -m defensive_model_vae_tpu_torch.scripts.run_baseline_configs \\
        [--epochs 3000] [--conv-epochs 500] [--data-root DefensiveData] [--out FILE]

  1. the dense VAE on sce1: ``fused_train`` (K1), one warm run, then the
     timed one;
  2. the four scenario corpora in one K2 launch (``fused_train_multi``),
     then four samples from each sce1 start (``generate_trajectories``);
  3. the Conv1D VAE (``train_conv``) on ``generate_random_trajectories(256,
     50, 5.0, seed=0)`` for ``--conv-epochs`` epochs;
  4. the scenario-class + THW conditioned corpus
     (``build_conditioned_corpus``, ``train_conditioned``);
  5. generate → track → validate on sce2 (``pipeline.generate_and_track``,
     ``load_humans``, ``validate``) when ``--data-root`` holds the CARLA
     episode CSVs; otherwise JAX's ``"skipped (data root absent)"``.

Each config draws its seed from OS entropy and records it.  Times are the
host clock around calls that end on the host (their histories come back
as numpy arrays).  A failed K1 or K2 launch raises: unlike the JAX script
(:66-104), nothing falls back to the scan trainer.  The report is printed
as one JSON line and written to ``--out`` only when given.  Runs on the
card unless ``--device cpu``.
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
from ..data import build_dataset, collect_csv_files, generate_random_trajectories
from ..data.features import build_conditioned_corpus, window_trial_suffixes
from ..generate import generate_trajectories
from ..models import CVAEConfig
from ..ops import fused_train, fused_train_multi
from ..pipeline import generate_and_track, load_humans, validate
from ..train import TrainConfig, train_conditioned, train_conv
from ._timing import device_name, fresh_seed

SKIPPED = "skipped (data root absent)"


def _first_last(hist):
    return float(hist["total"][0]), float(hist["total"][-1])


def _suffixes(windows, data_root):
    """Each fixture's trial suffixes where the episodes under ``data_root``
    rebuild it exactly (sce4's THW distance depends on them), else None."""
    if not os.path.isdir(data_root):
        return None
    out = {}
    for k, w in windows.items():
        canonical = build_dataset(data_root, k)
        if canonical.shape == w.shape and np.array_equal(canonical, w):
            out[k] = window_trial_suffixes(data_root, k)
    return out


def run(epochs=3000, conv_epochs=500, data_root="DefensiveData", dev=None):
    """The five configs → the report (module docstring)."""
    windows = {k: np.load(scenarios.get(k).fixture_windows) for k in scenarios.REGISTRY}
    report = {"device": device_name(dev), "epochs": epochs}
    # the K1 family runs its kernels on the card and their plain versions on
    # the CPU tensors
    how = "one kernel launch" if dev.type == "cuda" else "its plain version, on the CPU"

    # ---- 1: the dense VAE on sce1, K1 ----
    s1 = fresh_seed()
    t0 = time.perf_counter()
    fused_train(windows["sce1"], epochs=epochs, seed=s1 + 7, device=dev)
    warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, hist1 = fused_train(windows["sce1"], epochs=epochs, seed=s1, device=dev)
    first, last = _first_last(hist1)
    report["config1_dense_sce1"] = {
        "trainer": f"k1 ({how})", "warmup_s": warmup,
        "seconds_warm": time.perf_counter() - t0, "loss_first": first,
        "final_loss": last, "timing_seed": s1}

    # ---- 2: the four corpora in one K2 launch, then sampling ----
    s2 = fresh_seed()
    t0 = time.perf_counter()
    params_by, hist_by = fused_train_multi(windows, epochs=epochs, seed=s2, device=dev)
    cfg = CVAEConfig()
    gen = generate_trajectories(params_by["sce1"], cfg, windows["sce1"][:, 0, 1:3],
                                n_samples=4, seed=0)
    report["config2_four_scenarios"] = {
        "mode": f"k2 ({how})", "seconds": time.perf_counter() - t0,
        "first_losses": {k: float(h["total"][0]) for k, h in hist_by.items()},
        "final_losses": {k: float(h["total"][-1]) for k, h in hist_by.items()},
        "generated_shape": list(np.asarray(gen).shape),
        "generated_finite": bool(np.isfinite(gen).all()), "timing_seed": s2}

    # ---- 3: the Conv1D VAE over long windows ----
    s3 = fresh_seed()
    t0 = time.perf_counter()
    long_windows = generate_random_trajectories(256, 50, 5.0, seed=0).astype(np.float32)
    _, hist3, _ = train_conv(long_windows, train_cfg=TrainConfig(epochs=conv_epochs, seed=s3),
                             device=dev)
    first, last = _first_last(hist3)
    report["config3_conv_long_windows"] = {
        "window_shape": [50, 2], "epochs": conv_epochs, "seconds": time.perf_counter() - t0,
        "loss_first": first, "loss_final": last, "timing_seed": s3}

    # ---- 4: the scenario-class + THW conditioned corpus ----
    t0 = time.perf_counter()
    corpus, extra = build_conditioned_corpus(
        windows, suffixes_by_scenario=_suffixes(windows, data_root))
    s4 = fresh_seed()
    _, hist4, cfg4 = train_conditioned(corpus, extra, TrainConfig(epochs=epochs, seed=s4),
                                       device=dev)
    first, last = _first_last(hist4)
    report["config4_conditioned"] = {
        "corpus_size": int(corpus.shape[0]), "cond_dim": cfg4.cond_dim,
        "seconds": time.perf_counter() - t0, "loss_first": first, "final_loss": last,
        "timing_seed": s4}

    # ---- 5: generate -> track -> validate, with the episode CSVs ----
    if os.path.isdir(data_root):
        t0 = time.perf_counter()
        s5 = fresh_seed()
        sce = scenarios.get("sce2")
        csvs = collect_csv_files(os.path.join(data_root, sce.town))
        traces, _ = generate_and_track(params_by["sce2"], cfg, sce, csvs, seed=s5)
        rep = validate(traces, load_humans(sce, csvs), sce)
        rep["seconds"] = time.perf_counter() - t0
        rep["timing_seed"] = s5
        report["config5_end_to_end_sce2"] = rep
    else:
        report["config5_end_to_end_sce2"] = SKIPPED
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--conv-epochs", type=int, default=500,
                    help="config 3's epochs (JAX's script fixes 500)")
    ap.add_argument("--data-root", default="DefensiveData",
                    help="the CARLA episode CSVs for config 5 (skipped if absent)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    if min(args.epochs, args.conv_epochs) < 1:
        raise SystemExit("--epochs and --conv-epochs must be at least 1")
    report = run(args.epochs, args.conv_epochs, args.data_root, resolve_device(args.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"baseline_configs": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
