"""A generated ε stream and what consumes it: ``torch.sum`` against the P2
kernel, which streams it in 2048-row tiles.

Port of the JAX package's ``scripts/noise_consumer_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.noise_consumer_probe \\
        [--epochs 200] [--n 131072] [--reps 4] [--out FILE]

Each variant draws the hbm ε stream of the production-scale trainer
(``ops/fused_scale.py::hbm_noise``: (epochs·n, 8) bf16, 419 MB at the bench
shape) from a fresh seed and consumes it, inside one timed window (CUDA
events):

  sum      ``torch.sum`` of the stream in float32 (eager torch always
           materialises the stream first)
  stream   the stream into the P2 kernel (``ops/scale_ablation.py::
           p2_stream_sum``), tile-wise, into one (1, 8) row

JAX crosses these with two generator implementations (threefry, rbg).
torch's CUDA generator has one, Philox4x32-10 (``hbm_noise_impl``), so that
axis collapses; the output says so.  Rep 0 is untimed.  The result is
printed as one JSON line and written to ``--out`` only when given.  Runs on
the card unless ``--device cpu``; ``--smoke`` is a CPU run at 2 epochs ×
4,096 rows.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .._device import resolve_device
from ..ops import fused_scale as fs
from ..ops import scale_ablation as sa
from ._timing import device_name, fresh_seed, timed

Z, TILE = 8, 2048


def consume(variant, seed, epochs, n, dev):
    """Draw the stream of ``seed`` and consume it → (1, 8) float32."""
    eps = fs.hbm_noise(seed, epochs, n, Z, "bfloat16", dev)
    if variant == "sum":
        return torch.sum(eps.float()).reshape(1, 1).expand(1, 8)
    return sa.p2_stream_sum(eps, TILE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=4, help="1 untimed warm + reps-1 timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    ap.add_argument("--smoke", action="store_true", help="CPU, 2 epochs x 4096 rows")
    args = ap.parse_args(argv)
    if args.smoke:
        args.epochs, args.n, args.reps, args.device = 2, 4096, 2, "cpu"
    dev = resolve_device(args.device)
    if (args.epochs * args.n) % TILE:
        raise SystemExit(f"epochs x n must be a multiple of the tile {TILE}")
    variants = ("sum", "stream")
    times = {v: [] for v in variants}
    for rep in range(args.reps):
        for v in variants:
            seed = fresh_seed()
            dt, out = timed(lambda: consume(v, seed, args.epochs, args.n, dev), dev)
            if not torch.isfinite(out).all():
                raise SystemExit(f"{v}: non-finite sum")
            if rep:
                times[v].append(dt)
            print(f"{'cold' if rep == 0 else f'rep{rep}'} {v}: {dt:.4f}s", file=sys.stderr)
    res = {"epochs": args.epochs, "n_pad": args.n, "z": Z, "tile": TILE,
           "rows": args.epochs * args.n, "device": device_name(dev),
           "impl": fs.hbm_noise_impl(dev),
           "impl_axis": "collapsed: torch's generator on this device has one "
                        "implementation",
           "variants": {v: {"best_s": min(ts), "all_s": ts} for v, ts in times.items()
                        if ts}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
    print(json.dumps({"noise_consumer_probe": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
