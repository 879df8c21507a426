"""Is the hbm ε stream's cost in generating ε or in streaming it?  And the
explicit-transpose (dwT) weight gradients beside each noise source.

Port of the JAX package's ``scripts/hot_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.hot_probe \\
        [--n 131072] [--epochs 200] [--tile 2048] [--reps 4] [--out FILE]

K3 (``ops/fused_scale.py::_fused_scale_call``) in bf16 at the bench width
(``bench.py::_scale_corpus``), each variant timed by CUDA events, rep 0
untimed, the variants interleaved rep by rep:

  gen          the hbm stream alone: ``hbm_noise``, (epochs·n, 8) bf16
               drawn by torch's generator, nothing consuming it
  packed       K3 with ε packed in the corpus, constant over the epochs
               (a fresh ε each rep): no stream
  packed+dwT   the same under the dwT knob (``csrc/fused_scale_knob.cu``'s
               instance: each weight gradient through an explicit
               transpose of its activations)
  hbm          K3 with a fresh ε an epoch streamed from device memory, the
               stream drawn inside the timed window as the production path
               draws it
  hbm+dwT      the same under the dwT knob
  prng         K3 drawing ε inside the kernel (Philox), no stream

JAX crosses three ``jax.random`` implementations with these; torch's CUDA
generator has one (Philox4x32-10), so that axis collapses to the port's
own noise sources.  ``split_s``: hbm − packed is what the stream costs,
``gen`` what drawing it costs, and their difference what streaming it
costs; the verdict names the larger, or says that hbm − packed is within
the spread of their reps.  Each K3 variant's last-epoch loss
is held finite and below its first (JAX's sanity check).  The result is
printed as one JSON line and written to ``--out`` only when given.  Runs
on the card unless ``--device cpu`` (K3's plain version; host clock).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_scale as fs
from ..ops.fused_trainer import _flatten_params, fused_inputs
from ._timing import device_name, fresh_seed, timed
from .scale_ablation import scale_corpus

N, EPOCHS, TILE, REPS = 131072, 200, 2048, 4
DTYPE = "bfloat16"
VARIANTS = ("gen", "packed", "packed+dwT", "hbm", "hbm+dwT", "prng")


class HotProbe:
    """The corpora (ε packed fresh for each rep, and without ε) and the
    initial params, made once; one run of each variant."""

    def __init__(self, n, epochs, tile, reps, dev):
        if n % tile:
            raise ValueError(f"--n {n} is not a multiple of the tile {tile}")
        self.n, self.epochs, self.tile, self.dev = n, epochs, tile, dev
        windows = scale_corpus(n)
        self.cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
        self.lw = LossWeights()
        x_flat, start = fused_inputs(windows, dev)
        mask = torch.ones(n, device=dev)
        self.plist = _flatten_params(init_params(torch.Generator().manual_seed(0),
                                                 self.cfg, dev))
        z = self.cfg.latent_dim
        self.packed_zero = fs._pack_corpus(x_flat, start, mask, None, z).to(
            torch.bfloat16).contiguous()
        erng = np.random.default_rng()
        self.packed_eps = [
            fs._pack_corpus(x_flat, start, mask, torch.tensor(
                erng.normal(size=(n, z)), dtype=torch.float32).to(dev), z).to(
                torch.bfloat16).contiguous()
            for _ in range(reps + 1)]

    def run(self, variant, rep, seed):
        """One run of ``variant`` → its (epochs, 8) metrics, or None (gen)."""
        if variant == "gen":
            fs.hbm_noise(seed, self.epochs, self.n, self.cfg.latent_dim, DTYPE, self.dev)
            return None
        noise = variant.split("+")[0]
        packed = self.packed_eps[rep] if noise == "packed" else self.packed_zero
        ablate = ("dwT",) if variant.endswith("+dwT") else ()
        return fs._fused_scale_call(self.plist, packed, seed, self.cfg, self.lw, self.epochs,
                                    1e-3, self.tile, float(self.n), DTYPE, noise,
                                    _ablate=ablate, backward="manual")[1]


def split(times):
    """The hbm stream's cost taken apart (seconds) from each variant's
    times; the verdict is "unresolved" when hbm − packed is within the
    spread of either one's reps, or there is one rep."""
    best = {v: min(ts) for v, ts in times.items()}
    stream_total = best["hbm"] - best["packed"]
    spread = max(max(times[v]) - min(times[v]) for v in ("packed", "hbm"))
    out = {"hbm_over_packed": stream_total, "generation": best["gen"],
           "streaming": stream_total - best["gen"], "reps_spread": spread,
           "hbm_over_prng": best["hbm"] - best["prng"],
           "dwT_saves_hbm": best["hbm"] - best["hbm+dwT"],
           "dwT_saves_packed": best["packed"] - best["packed+dwT"]}
    out["verdict"] = ("unresolved: one timed rep shows no spread" if len(times["hbm"]) < 2
                      else "unresolved: hbm - packed is within the reps' spread"
                      if abs(stream_total) <= spread
                      else "generation" if out["generation"] >= out["streaming"]
                      else "streaming")
    return out


def run_probe(n=N, epochs=EPOCHS, tile=TILE, reps=REPS, dev=None, log=None):
    """The probe → its result dict (module docstring)."""
    probe = HotProbe(n, epochs, tile, reps, dev)
    times = {v: [] for v in VARIANTS}
    last = {}
    for rep in range(reps + 1):
        for v in VARIANTS:
            seed = fresh_seed()
            dt, m = timed(lambda: probe.run(v, rep, seed), dev)
            if m is not None:
                last[v] = m
            if rep:
                times[v].append(dt)
            if log:
                print(f"{'cold' if rep == 0 else f'rep{rep}'} {v}: {dt:.4f}s", file=log)
    losses = {}
    for v, m in last.items():
        first, fin = float(m[0, 0]), float(m[epochs - 1, 0])
        if not (np.isfinite(fin) and fin < first):
            raise SystemExit(f"hot_probe: {v} did not train: loss {first} -> {fin}")
        losses[v] = [first, fin]
    best = {v: min(ts) for v, ts in times.items()}
    return {"n": n, "epochs": epochs, "tile": tile, "reps": reps, "dtype": DTYPE,
            "device": device_name(dev), "noise_impl": fs.hbm_noise_impl(dev),
            "impl_axis": "collapsed: torch's generator on this device has one "
                         "implementation",
            "losses_first_last": losses,
            "variants": {v: {"best_s": best[v], "all_s": times[v],
                             "mwindows_per_s": (None if v == "gen"
                                                else epochs * n / best[v] / 1e6)}
                         for v in VARIANTS},
            "split_s": split(times)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--tile", type=int, default=TILE)
    ap.add_argument("--reps", type=int, default=REPS, help="timed reps after one untimed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    if min(args.n, args.epochs, args.tile, args.reps) < 1:
        raise SystemExit("--n, --epochs, --tile and --reps must be at least 1")
    out = run_probe(args.n, args.epochs, args.tile, args.reps, resolve_device(args.device),
                    log=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"hot_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
