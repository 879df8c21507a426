"""K3's time taken apart: the production-scale trainer's variants, each
removing one layer of work, timed interleaved in one process.

Port of the JAX package's ``scripts/scale_ablation.py``:

    python -m defensive_model_vae_tpu_torch.scripts.scale_ablation \\
        [--n 131072] [--epochs 200] [--reps 5] [--tile 2048] [--out FILE]
    python -m defensive_model_vae_tpu_torch.scripts.scale_ablation --smoke

Variants, all bf16 at the bench shape (``bench.py::_scale_corpus``):

  full         K3 with the autodiff backward (backward="auto"), ε drawn in
               the kernel (prng)
  manual       K3, ε drawn in the kernel (prng)
  full_eps     K3 with the autodiff backward, ε packed in the corpus,
               constant over the epochs
  manual_eps   K3, ε packed in the corpus, constant over the epochs
  hbm          K3, fresh-per-epoch ε streamed from device memory (the
               production default)
  hbm_noadam   hbm without Adam                      -> Adam's cost
  hbm_noacc    hbm, the gradient sum kept only for the last tile
                                                     -> cross-tile sum's cost
  hbm_biasdot  hbm, bias gradients of bf16-rounded dy
  hbm_chaincd  hbm, the dY chain in bf16
  hbm_nodw     hbm without weight and bias gradients -> the dW side
  hbm_fwdonly  hbm without the backward              -> forward floor
  hbm_dwT      hbm, each weight gradient through an explicit transpose of
               its activations (the knob JAX's scripts/hot_probe.py times)
  hbm_t1024 / hbm_t4096  hbm at another tile: on this card the kernel
               streams 32-row steps whatever the tile, so only the noise
               keying changes; their times check that the tile is immaterial
  dx           P1: forward + the gradient in x (JAX autodiff's rounding)
  fwd          P1: forward and loss only
  sol          P1: K3's products' FLOPs as chained products, nothing else
  stream       P1: read the block, sum it, write the sum

Each rep draws fresh inputs (a fresh packed ε, a fresh seed for the hbm
stream, which is drawn inside the timed window as JAX draws it inside its
program); rep 0 is untimed.  Times are CUDA events.  The result is printed
as one JSON line and written to ``--out`` only when given.  ``--smoke`` runs
on the CPU at JAX's smoke shape (N 64, 9 epochs, tile 16, one rep) and
applies JAX's asserts.  Runs on the card unless ``--device cpu``.
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
from ..ops import scale_ablation as sa
from ..ops.fused_trainer import _flatten_params, fused_inputs
from ._timing import device_name, fresh_seed, timed

HBM_KNOBS = {"hbm_noadam": ("noadam",), "hbm_noacc": ("noacc",),
             "hbm_biasdot": ("biasdot",), "hbm_chaincd": ("chaincd",),
             "hbm_nodw": ("nodw",), "hbm_fwdonly": ("fwdonly",),
             "hbm_dwT": ("dwT",)}
HBM_TILES = {"hbm_t1024": 1024, "hbm_t4096": 4096}
# (noise, backward) of the four K3 variants without a knob
K3_RUNS = {"full": ("prng", "auto"), "manual": ("prng", "manual"),
           "full_eps": ("packed", "auto"), "manual_eps": ("packed", "manual")}
VARIANTS = (list(K3_RUNS) + ["hbm"] + list(HBM_KNOBS) + list(HBM_TILES)
            + ["dx", "fwd", "sol", "stream"])


def scale_corpus(n, seq_len=10, dim=3, seed=0):
    """Synthetic production-scale corpus with reference-like coordinate
    scales — a copy of ``bench.py::_scale_corpus`` (:346), whose seed is 0."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.2, (n, seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal([[-193.0, 50.0]], [[1.0, 20.0]], (n, seq_len, dim - 1)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


class Ablation:
    """The inputs of every variant, made once, and one run of each."""

    def __init__(self, n, epochs, tile, reps, dev, variants, smoke=False):
        self.n, self.epochs, self.tile, self.dev, self.smoke = n, epochs, tile, dev, smoke
        windows = scale_corpus(n)
        self.cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
        self.lw = LossWeights()
        for t in {HBM_TILES.get(v, tile) for v in variants}:
            if n % t:
                raise ValueError(f"--n {n} is not a multiple of the tile {t}")
        x_flat, start = fused_inputs(windows, dev)
        mask = torch.ones(n, device=dev)
        self.plist = _flatten_params(init_params(torch.Generator().manual_seed(0),
                                                 self.cfg, dev))
        width = self.cfg.seq_len * self.cfg.dim + self.cfg.cond_dim + 1 + self.cfg.latent_dim
        self.n_chain = sa.sol_chain_length(self.cfg)
        rng = np.random.default_rng(0)
        # sol's weights: scaled to keep the relu-free chain bounded
        self.w_in = torch.tensor(rng.normal(0, 1 / np.sqrt(width), (width, 128)),
                                 dtype=torch.float32).to(torch.bfloat16).to(dev)
        self.w_chain = torch.tensor(rng.normal(0, 1 / np.sqrt(128), (128, 128)),
                                    dtype=torch.float32).to(torch.bfloat16).to(dev)
        self.packed_zero = fs._pack_corpus(x_flat, start, mask, None,
                                           self.cfg.latent_dim).to(torch.bfloat16).contiguous()
        erng = np.random.default_rng()
        self.packed_eps = [
            fs._pack_corpus(x_flat, start, mask, torch.tensor(
                erng.normal(size=(n, self.cfg.latent_dim)), dtype=torch.float32).to(dev),
                self.cfg.latent_dim).to(torch.bfloat16).contiguous()
            for _ in range(reps)]

    def seed(self, variant):
        # the smoke pins the hbm family's seed: one ε stream for all of them,
        # so their epoch-0 rows agree exactly
        return 42 if (self.smoke and variant.startswith("hbm")) else fresh_seed()

    def run(self, variant, rep, seed):
        """One run of ``variant`` → its (epochs, 8) metrics."""
        common = (self.cfg, self.lw, self.epochs, 1e-3)
        nv = float(self.n)
        if variant in K3_RUNS:
            noise, backward = K3_RUNS[variant]
            packed = self.packed_zero if noise == "prng" else self.packed_eps[rep]
            return fs._fused_scale_call(self.plist, packed, seed, *common, self.tile, nv,
                                        "bfloat16", noise, backward=backward)[1]
        if variant.startswith("hbm"):
            return fs._fused_scale_call(self.plist, self.packed_zero, seed, *common,
                                        HBM_TILES.get(variant, self.tile), nv, "bfloat16",
                                        "hbm", _ablate=HBM_KNOBS.get(variant, ()))[1]
        packed = self.packed_eps[rep]
        if variant == "sol":
            return sa.p1_sol(packed, self.w_in, self.w_chain, self.n_chain, self.epochs,
                             self.tile)
        if variant == "stream":
            return sa.p1_stream(packed, self.epochs, self.tile)
        return sa.p1_ablation(packed, self.plist, variant, self.cfg, self.lw, nv,
                              self.epochs, self.tile)


def breakdown(b):
    """The buckets (seconds) from the variants' best times ``b``."""
    return {
        "manual_backward_saves": b["full"] - b["manual"],
        "prng": b["full"] - b["full_eps"],
        "prng_manual": b["manual"] - b["manual_eps"],
        "hbm_stream_overhead_vs_packed": b["hbm"] - b["manual_eps"],
        "adam": b["hbm"] - b["hbm_noadam"],
        "acc_read_add": b["hbm"] - b["hbm_noacc"],
        "biasdot_saves": b["hbm"] - b["hbm_biasdot"],
        "chaincd_saves": b["hbm"] - b["hbm_chaincd"],
        "dwT_saves": b["hbm"] - b["hbm_dwT"],
        # the manual backward on K3 itself: hbm − nodw = dW/db products;
        # nodw − fwdonly = the dY chain; fwdonly = forward + stream + reduce
        "manual_dw": b["hbm"] - b["hbm_nodw"],
        "manual_dy_chain": b["hbm_nodw"] - b["hbm_fwdonly"],
        "manual_fwd_floor": b["hbm_fwdonly"],
        "dw_acc_adam": b["full_eps"] - b["dx"],
        "dy_chain": b["dx"] - b["fwd"],
        "fwd_overhead_vs_sol": b["fwd"] - b["sol"],
        "sol_vs_stream": b["sol"] - b["stream"],
        "stream_floor": b["stream"],
    }


def smoke_asserts(last, epochs):
    """JAX's smoke asserts (scripts/scale_ablation.py:391-435)."""
    fe, me, dx, fw, hb = (last[k] for k in ("full_eps", "manual_eps", "dx", "fwd", "hbm"))
    # fwd, dx and full_eps compute the same loss from the same params on
    # epoch 0; fwd's rows stay constant while training moves full_eps's;
    # the manual backward shares the forward and descends like autodiff
    assert np.allclose(fe[0, :5], fw[0, :5], rtol=1e-4), (fe[0], fw[0])
    assert np.allclose(dx[0, :5], fw[0, :5], rtol=1e-4), (dx[0], fw[0])
    assert np.allclose(me[0, :5], fe[0, :5], rtol=1e-4), (me[0], fe[0])
    assert not np.allclose(me[0, 0], me[epochs - 1, 0], rtol=1e-3)
    assert np.allclose(fw[0, :5], fw[epochs - 1, :5], rtol=1e-4)
    assert not np.allclose(fe[0, 0], fe[epochs - 1, 0], rtol=1e-3)
    assert np.isfinite(dx[0, 5])
    assert np.isfinite(last["sol"][:epochs, 0]).all()
    assert np.isfinite(last["stream"][:epochs, 0]).all()
    # the hbm family shares one seed, so one ε stream and one init: the
    # epoch-0 loss rows agree; noadam never updates params; the others descend
    for k in HBM_KNOBS:
        assert np.allclose(last[k][0, :5], hb[0, :5], rtol=1e-5), k
    assert not np.allclose(hb[0, 0], hb[epochs - 1, 0], rtol=1e-3)
    for k in ("hbm_biasdot", "hbm_chaincd", "hbm_dwT"):
        assert not np.allclose(last[k][0, 0], last[k][epochs - 1, 0], rtol=1e-3), k
    # fwdonly takes no step: its rows are the initial params' loss under
    # each epoch's ε, finite and apart from hbm's descended last row
    assert np.isfinite(last["hbm_fwdonly"][:epochs, :5]).all()
    assert not np.allclose(last["hbm_fwdonly"][epochs - 1, 0], hb[epochs - 1, 0], rtol=1e-3)


def run_ablation(n, epochs, tile, reps, dev, variants=VARIANTS, smoke=False, log=None):
    """Every variant ``reps`` times, interleaved; rep 0 untimed → the
    result dict (variants' times, buckets) and the last metrics of each."""
    ab = Ablation(n, epochs, tile, reps, dev, variants, smoke)
    times = {v: [] for v in variants}
    last = {}
    for rep in range(reps):
        for v in variants:
            seed = ab.seed(v)
            dt, m = timed(lambda: ab.run(v, rep, seed), dev)
            last[v] = m.cpu().numpy()
            if rep:
                times[v].append(dt)
            if log:
                print(f"{'cold' if rep == 0 else f'rep{rep}'} {v}: {dt:.4f}s", file=log)
    out = {"n": n, "epochs": epochs, "tile": tile, "grid_steps": epochs * (n // tile),
           "reps": reps - 1, "device": device_name(dev),
           "noise_impl": fs.hbm_noise_impl(dev), "sol_chain": ab.n_chain,
           "variants": {}}
    if reps > 1:
        best = {v: min(ts) for v, ts in times.items()}
        steps = out["grid_steps"]
        out["variants"] = {v: {"best_s": best[v], "all_s": times[v],
                               "us_per_grid_step": best[v] / steps * 1e6,
                               "mwindows_per_s": epochs * n / best[v] / 1e6}
                           for v in variants}
        if set(VARIANTS) <= set(variants):
            out["breakdown_s"] = breakdown(best)
    return out, last


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5, help="1 untimed warm + reps-1 timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU, N 64, 9 epochs, tile 16, one rep; JAX's asserts")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.epochs, args.tile, args.reps, args.device = 64, 9, 16, 1, "cpu"
    dev = resolve_device(args.device)
    variants = [v for v in VARIANTS if not (args.smoke and v in HBM_TILES)]
    out, last = run_ablation(args.n, args.epochs, args.tile, args.reps, dev, variants,
                             smoke=args.smoke, log=sys.stderr)
    if args.smoke:
        smoke_asserts(last, args.epochs)
        print("SMOKE OK: ablation variants agree on epoch-0 loss components")
        return 0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"scale_ablation": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
