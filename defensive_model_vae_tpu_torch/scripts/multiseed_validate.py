"""The unselected multi-seed band of every scenario's validation metrics.

Port of the JAX package's ``scripts/multiseed_validate.py``:

    python -m defensive_model_vae_tpu_torch.scripts.multiseed_validate \\
        --data-root DIR [--scenarios sce1] [--gen-seeds 0,1,2] [--chunk 10] \\
        [--out FILE] [--progress FILE]

For each scenario: load its committed checkpoint, run generate → track →
validate once per reporting generation seed (``DEFAULT_GEN_SEEDS``: 70
seeds, 0–4 and 10–74; 5–9 are the selection seeds of ``seed_sweep`` and
stay out), every seed's samples in one tracking batch, and record each
metric's ``band_stats`` (mean, std, 95% CI, values) with a provenance
block per scenario.  With ``--out`` an existing document there keeps the
blocks of the scenarios not asked for.

``--chunk N`` tracks N seeds a batch and writes each finished seed's report
to ``--progress`` (default ``<out>.progress``) as it lands, so a rerun
after a crash resumes from the seeds that are done (the file names the
checkpoint, the seeds and the data root by :func:`progress_fingerprint`;
a stale one is discarded), and the band is assembled in seed order.  A row
tracked in a batch of another width is the single call's up to the
rounding of batched products of that width, so chunked and single-call
bands may differ in the last digits; the provenance records the chunk.

On episode trees written from the committed windows (``scripts/episodes.py``)
the band describes that data, not the human logs.  A missing tree is an
error naming it.  The document is printed as one JSON line and written to
``--out`` only when given.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from .. import scenarios
from .._device import resolve_device
from ..data import collect_csv_files
from ..pipeline import generate_and_track_multi, load_humans, provenance, validate
from ..train import load_checkpoint
from ..utils import band_stats, jsonable

METRICS = [
    "velocity_js_divergence", "rmse_frequency_points",
    "rmse_frequency_trajcount", "surface_rmse_with_zeros",
    "surface_rmse_no_zeros", "plane_centroid_rmse",
]

# 70 unselected seeds: 0-4 plus 10-74 (5-9 are seed_sweep's selection
# seeds and stay out of the reporting band)
DEFAULT_GEN_SEEDS = ",".join(map(str, list(range(5)) + list(range(10, 75))))


def progress_fingerprint(manifest: dict, gens, data_root: str) -> str:
    """Identity of a band computation, for crash-resume validity: the
    checkpoint's manifest, the gen-seed list and the data root.  A progress
    file from another checkpoint (checkpoints are reselected between
    rounds) must not seed a band written under the new provenance."""
    blob = json.dumps(
        {"manifest": manifest, "gens": list(gens), "data_root": data_root},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)


def band(key, gens, data_root, ckpt_root, chunk, progress_path, dev):
    """One scenario's band → (its block {metric: band_stats}, its
    provenance)."""
    sce = scenarios.get(key)
    tree = os.path.join(data_root, sce.town)
    if not os.path.isdir(tree):
        raise SystemExit(f"multiseed_validate: no episode tree for {sce.key} at {tree}")
    params, cfg, manifest = load_checkpoint(os.path.join(ckpt_root, sce.key), dev)
    csvs = collect_csv_files(tree)
    humans = load_humans(sce, csvs)
    fp = progress_fingerprint(manifest, gens, data_root)
    done = {}
    if chunk and os.path.exists(progress_path):
        block = _read(progress_path).get(sce.key, {})
        if block.get("fingerprint") == fp:
            done = {int(k): v for k, v in block.get("reports", {}).items()}
            if done:
                _log(f"{sce.key}: resuming — {len(done)} seeds already in {progress_path}")
        elif block:
            _log(f"{sce.key}: DISCARDING stale progress in {progress_path} "
                 "(checkpoint/gen-seed/data-root fingerprint mismatch)")
    todo = [g for g in gens if g not in done]
    parts = ([todo[i:i + chunk] for i in range(0, len(todo), chunk)] if chunk
             else ([todo] if todo else []))
    for part in parts:
        t0 = time.perf_counter()
        tracked = generate_and_track_multi(params, cfg, sce, csvs, seeds=part)
        _log(f"{sce.key}: {len(part)}-seed batched generate+track "
             f"({time.perf_counter() - t0:.1f}s)")
        for g in part:
            done[g] = rep = validate(tracked[g][0], humans, sce)
            _log(f"{sce.key} gen seed {g}: js={rep['velocity_js_divergence']:.4f} "
                 f"surface={rep['surface_rmse_with_zeros']:.4f}")
        if chunk:
            prog = _read(progress_path) if os.path.exists(progress_path) else {}
            prog[sce.key] = {"fingerprint": fp,
                             "reports": {str(g): jsonable(done[g]) for g in done}}
            _write(progress_path, prog)
    if chunk and os.path.exists(progress_path):
        # the file is for crash-resume only: clear this scenario's block on
        # success, so no later run resumes from finished work
        prog = _read(progress_path)
        if prog.pop(sce.key, None) is not None:
            _write(progress_path, prog)
    notes = [
        f"multiseed band: gen seeds {','.join(map(str, gens))} (unselected; "
        "train-seed selection uses disjoint seeds — scripts/seed_sweep.py); "
        "checkpoint per manifest.json"
    ]
    if chunk:
        notes.append(
            f"tracked in {chunk}-seed chunked batches (crash-resume); a row is the "
            "single batch's up to the rounding of batched products of another width")
    if manifest.get("selection"):
        notes.append(f"checkpoint train seed {manifest.get('selected_seed')} "
                     f"({manifest['selection']})")
    # a resumed report's null (a non-finite metric) is NaN in band_stats
    block = {m: band_stats(done[g][m] for g in gens) for m in METRICS}
    return block, provenance(sce, -1, n_csvs=len(csvs), notes=notes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", default="sce1,sce2,sce3,sce4")
    ap.add_argument("--gen-seeds", default=DEFAULT_GEN_SEEDS)
    ap.add_argument("--data-root", default="DefensiveData")
    ap.add_argument("--ckpt-root", default="results/checkpoints")
    ap.add_argument("--out", help="also write the document here, keeping the blocks of "
                                  "the scenarios not asked for (JSON)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="seeds per tracking batch (0 = all in one)")
    ap.add_argument("--progress", default=None,
                    help="per-seed report checkpoint for crash-resume, used with "
                         "--chunk (default <out>.progress)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    progress_path = args.progress or (f"{args.out}.progress" if args.out else None)
    if args.chunk and progress_path is None:
        raise SystemExit("multiseed_validate: --chunk needs --progress or --out")
    dev = resolve_device(args.device)
    gens = [int(v) for v in args.gen_seeds.split(",")]
    doc = _read(args.out) if args.out and os.path.exists(args.out) else {}
    prov = doc.get("provenance", {})
    for key in args.scenarios.split(","):
        block, p = band(key, gens, args.data_root, args.ckpt_root, args.chunk,
                        progress_path, dev)
        doc[scenarios.get(key).key] = block
        prov[scenarios.get(key).key] = p
    doc["provenance"] = prov
    doc = jsonable(doc)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    print(json.dumps({"multiseed_validate": doc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
