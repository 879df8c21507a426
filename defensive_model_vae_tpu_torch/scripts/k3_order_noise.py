"""How far K3's and K4's plain versions move against themselves when only
the summation order of their products changes, at the cases where
``chip_smoke.py`` holds the kernels to ``K3_TOL``'s bf16 rows and to
``K4_TOL``'s float32 row:

    python -m defensive_model_vae_tpu_torch.scripts.k3_order_noise [--seeds 8] [--device cpu]

The order is moved as ``scripts/sol_checks.py::order_noise`` moves
P1-sol's: the hidden units of every hidden layer (the outputs of cond_0,
cond_1, enc_0-3 and dec_0-2) are permuted, each layer's weight columns and
bias with its perm and the next layer's weight rows with it (fc_mu and
fc_logvar read [enc_3, cond_1], dec_0 reads [z, cond_1]).  The network is
the same function, but every product over a hidden index sums its terms
in another order, and bf16 rounds the same float32 values.  A run from the
permuted params, its result permuted back into place, against the run from
the params as they are: the gap is the plain version's own order spread.

Each case prints the largest spread over the seeds in ``k3_gaps``'s terms
(chip_smoke.py: the largest parameter gap, the largest share of an array's
elements over a tenth of Adam's step, the loss rows' relative gap; for K4
each gradient array's gap as a fraction of its max) beside the limit that
holds the kernel there, and whether the limit sits above it.  One JSON line.
The plain versions run on the CPU by default (the numbers are the function's
own, not a device's).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_scale as fs
from ..ops import fused_trainer as ft
from .scale_ablation import scale_corpus

CFG, LW = CVAEConfig(), LossWeights()
STEP_TENTH = 1e-4
# chip_smoke.py's limits at these cases (K3_TOL's bf16 rows; K4_TOL[None])
K3_BF16_TOL = {1: {"params_abs": 1e-5, "params_frac": 0.0, "metrics_rel": 1e-5},
               3: {"params_abs": 5e-3, "params_frac": 0.05, "metrics_rel": 1e-3},
               20: {"params_abs": 5e-3, "params_frac": 0.05, "metrics_rel": 1e-3}}
K4_F32_TOL = {"grad_rel_max": 1e-5, "row_rel": 1e-5}
# (name, rows, tile, noise, noise seed, epochs) as chip_smoke.py runs them:
# k3_vs_plain's bf16 case and ablation_vs_plain's corpus (K3 with no knob)
K3_CASES = (("k3_vs_plain", 4096, 512, "hbm", 3, (1, 20)),
            ("ablation_vs_plain", 8448, 352, "packed", 3, (1, 3)))
# tests/test_torch_scale_card.py's ragged K4 float32 case: 9000 rows of its
# corpus (seed 3), tiles of 352, prng noise from key 4
K4_CASE = (9000, 352, "prng", 4)
HIDDEN = ("cond_0", "cond_1", "enc_0", "enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2")
# each layer's input, part by part: a hidden layer's units or n fixed ones
INPUTS = {"cond_1": ("cond_0",), "enc_1": ("enc_0",), "enc_2": ("enc_1",),
          "enc_3": ("enc_2",), "fc_mu": ("enc_3", "cond_1"), "fc_logvar": ("enc_3", "cond_1"),
          "dec_0": (CFG.latent_dim, "cond_1"), "dec_1": ("dec_0",), "dec_2": ("dec_1",),
          "dec_3": ("dec_2",)}


def card_corpus(n, seed=3):
    """tests/test_torch_scale_card.py's random-walk windows."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def perms_of(seed, dev):
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randperm(CFG.hidden_dim, generator=g).to(dev) for name in HIDDEN}


def permute(flat, perms):
    """Flat params (or gradients) in ``ft._LAYERS`` order, every hidden
    layer's units moved by ``perms``."""
    out = []
    for i, name in enumerate(ft._LAYERS):
        w, b = flat[2 * i], flat[2 * i + 1]
        if name in perms:
            w, b = w[:, perms[name]], b[:, perms[name]]
        if name in INPUTS:
            rows, off = [], 0
            for part in INPUTS[name]:
                if isinstance(part, int):
                    rows.append(torch.arange(part, device=w.device) + off)
                    off += part
                else:
                    rows.append(perms[part] + off)
                    off += CFG.hidden_dim
            w = w[torch.cat(rows)]
        out += [w.contiguous(), b.contiguous()]
    return out


def k3_spread(a, b):
    """(params, metrics) against (params, metrics) in k3_gaps's terms."""
    (pa, ma), (pb, mb) = a, b
    return {"params_abs": max(float((x - y).abs().max()) for x, y in zip(pa, pb)),
            "params_frac": max(float(((x - y).abs() > STEP_TENTH).float().mean())
                               for x, y in zip(pa, pb)),
            "metrics_rel": float(((ma[:, :5] - mb[:, :5]).abs()
                                  / mb[:, :5].abs().clamp(min=1e-6)).max())}


def k3_case(name, n, tile, noise, seed, epochs, seeds, dev):
    eps = (np.random.default_rng(1).standard_normal((n, CFG.latent_dim)).astype(np.float32)
           if noise == "packed" else None)
    nv, packed = fs._scale_inputs(scale_corpus(n), CFG, tile, "bfloat16", eps, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    rows = []
    for ep in epochs:
        eps_all = (fs.hbm_noise(seed, ep, packed.shape[0], CFG.latent_dim, "bfloat16", dev)
                   if noise == "hbm" else None)

        def run(params):
            return fs._fused_scale_call_plain(params, packed, seed, CFG, LW, ep, 1e-3, tile,
                                              float(nv), "bfloat16", noise, eps_all)

        ref = run(plist)
        worst = dict.fromkeys(("params_abs", "params_frac", "metrics_rel"), 0.0)
        for s in range(seeds):
            perms = perms_of(s, dev)
            moved = run(permute(plist, perms))
            gap = k3_spread(moved, (permute(ref[0], perms), ref[1]))
            worst = {k: max(worst[k], gap[k]) for k in worst}
        tol = K3_BF16_TOL[ep]
        rows.append({"case": name, "n": n, "tile": tile, "noise": noise, "epochs": ep,
                     "spread": worst, "tol": tol,
                     "within": all(worst[k] <= tol[k] for k in worst)})
    return rows


def k4_case(seeds, dev):
    n, tile, noise, seed = K4_CASE
    nv, packed = fs._scale_inputs(card_corpus(n), CFG, tile, None, None, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))

    def run(params):
        src = fs._eps_source(noise, CFG, tile, packed.shape[0], None, seed, dev)
        return fs._plain_grad_epoch(params, packed, tile, CFG, LW, float(nv), None, src)

    gref, rref = run(plist)
    worst = {"grad_rel_max": 0.0, "row_rel": 0.0}
    for s in range(seeds):
        perms = perms_of(s, dev)
        g, r = run(permute(plist, perms))
        gp = permute(gref, perms)
        worst["grad_rel_max"] = max(worst["grad_rel_max"], max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
            for a, b in zip(g, gp)))
        worst["row_rel"] = max(worst["row_rel"], float(
            ((r[:5] - rref[:5]).abs() / rref[:5].abs().clamp(min=1e-6)).max()))
    return {"case": "k4_float32", "n": n, "tile": tile, "noise": noise, "spread": worst,
            "tol": K4_F32_TOL, "within": all(worst[k] <= K4_F32_TOL[k] for k in worst)}


# ---- the order-free case --------------------------------------------------
# One epoch of K4 (the gradient kernel K3 shares) at a point where every sum
# the function takes is exact in float32, so that any summation order gives
# the same bits: each weight matrix a signed partial permutation (at most one
# +-1 in each row and column, so every product over a hidden index has one
# term), biases, corpus and noise multiples of 1/4 and small, fc_logvar zero
# (so exp(logvar) = 1 exactly), EXACT_VALID valid rows of one tile (so the
# plain version's per-tile loss rows add exact zeros), n_valid a power of two
# and loss weights whose cotangent coefficients are powers of two (recon
# 15/8: 2 w S / 30 = S / 8; kld 0; start 1; time 1/2 on a reconstruction
# whose time columns increase, so the hinge never opens).  The latent rows
# and the encoder's mu units are chained through active units to the
# reconstruction, so every layer's gradient has nonzero elements.  Its sums
# stay far inside float32's 24 bits (values under 16 on a grid of 1/4, 64
# rows): the kernel must give the plain version's gradients and loss row bit
# for bit, in either dtype.
EXACT_ROWS, EXACT_TILE = 1056, 352
EXACT_VALID = range(380, 444)  # 64 rows over three 32-row steps of tile 1
# the deliberate error it must see: its first 32 valid rows masked out
EXACT_DROP = slice(EXACT_VALID.start, EXACT_VALID.start + 32)
EXACT_LW = LossWeights(recon=1.875, kld=0.0, start=1.0, time=0.5)


def exact_case(dev, compute_dtype, seed=0):
    """(plist, packed corpus with explicit eps, n_valid) of the order-free
    case (above)."""
    rng = np.random.default_rng(seed)
    H, Z, F, C, T, D = (CFG.hidden_dim, CFG.latent_dim, CFG.seq_len * CFG.dim,
                        CFG.cond_dim, CFG.seq_len, CFG.dim)
    spec = CFG.layer_spec()
    W = {n: np.zeros(spec[n]) for n in ft._LAYERS}
    B = {n: rng.integers(-1, 5, spec[n][1]) / 4.0 for n in ft._LAYERS}

    def link(name, rows, cols):
        W[name][rows, cols] = rng.choice([-1.0, 1.0], len(rows))

    link("cond_0", np.arange(C), rng.permutation(H)[:C])
    link("cond_1", np.arange(H), rng.permutation(H))
    unit = rng.permutation(H)[:F]  # the encoder's units fed by x
    link("enc_0", np.arange(F), unit)
    for name in ("enc_1", "enc_2", "enc_3"):
        p = rng.permutation(H)
        link(name, np.arange(H), p)
        unit = p[unit]
        B[name] = rng.integers(8, 13, H) / 4.0  # active: |x| <= 2 below them
    B["enc_0"] = rng.integers(8, 13, H) / 4.0
    link("fc_mu", unit[:Z], np.arange(Z))  # mu from enc_3's chained units
    B["fc_logvar"][:] = 0.0
    z_units = rng.permutation(H)[:Z]
    link("dec_0", np.concatenate([np.arange(Z), Z + rng.permutation(H)[:H - Z]]),
         np.concatenate([z_units, np.setdiff1d(np.arange(H), z_units)]))
    B["dec_0"][z_units] = 2.0
    for name in ("dec_1", "dec_2"):
        p = rng.permutation(H)
        link(name, np.arange(H), p)
        z_units = p[z_units]
        B[name][z_units] = 2.0
    xy = np.setdiff1d(np.arange(F), np.arange(0, F, D))  # the x and y columns
    rest = rng.permutation(np.setdiff1d(np.arange(H), z_units))[:len(xy) - Z]
    link("dec_3", np.concatenate([z_units, rest]), rng.permutation(xy))
    B["dec_3"][0::D] = 0.5 * np.arange(T) + 0.25  # increasing times
    f32 = dict(dtype=torch.float32, device=dev)
    plist = []
    for name in ft._LAYERS:
        plist += [torch.tensor(W[name], **f32), torch.tensor(B[name][None], **f32)]
    v = np.asarray(EXACT_VALID)
    cols = np.zeros((EXACT_ROWS, F + C + 1 + Z))
    cols[v, :F] = rng.integers(-8, 9, (len(v), F)) / 4.0
    cols[v, F:F + C] = rng.integers(-8, 9, (len(v), C)) / 4.0
    cols[v, F + C] = 1.0
    cols[v, F + C + 1:] = rng.integers(-8, 9, (len(v), Z)) / 4.0
    packed = torch.tensor(cols, **f32).to(fs._torch_dtype(compute_dtype)).contiguous()
    return plist, packed, float(len(v))


def exact_plain(plist, packed, n_valid, compute_dtype):
    """K4's plain version on the order-free case → (gradients, loss row)."""
    src = fs._eps_source("packed", CFG, EXACT_TILE, packed.shape[0], None, 0, packed.device)
    return fs._plain_grad_epoch(plist, packed, EXACT_TILE, CFG, EXACT_LW, n_valid,
                                compute_dtype, src)


def exact_kernel(plist, packed, n_valid, compute_dtype):
    """K4 on the order-free case → (gradients, loss row)."""
    grads, row = fs._grad_epoch_call(plist, packed, 0, CFG, EXACT_LW, EXACT_TILE, n_valid,
                                     compute_dtype, "packed", None)
    return grads, row[0, :5]


def exact_row(kernel, plain):
    """Kernel and plain version on the order-free case → (row, bit for bit)."""
    (gk, rk), (gp, rp) = kernel, plain
    unequal = [n for i, n in enumerate(ft._LAYERS)
               for q, j in (("w", 2 * i), ("b", 2 * i + 1)) if not torch.equal(gk[j], gp[j])]
    ok = not unequal and torch.equal(rk.reshape(-1), rp.reshape(-1))
    return {"bits_equal": ok, "unequal_arrays": unequal,
            "row_kernel": rk.reshape(-1).tolist(), "row_plain": rp.reshape(-1).tolist(),
            "nonzero_grads": int(sum(int((g != 0).sum()) for g in gp))}, ok


# K3 on the order-free case: one epoch, the gradients above and then Adam's
# first step.  With m and v zero, the kernel's m and v are the plain
# version's products whether or not the compiler fuses them into FMAs; its
# param update may fuse p - lr * step into one FMA where the plain version
# rounds lr * step first, so lr is a power of two, which makes that product
# exact.  From the second epoch on, 0.9 m + 0.1 g may be one FMA in the
# kernel and two roundings in the plain version, so one epoch only.
EXACT_LR = 2.0 ** -10


def exact_k3_plain(plist, packed, n_valid, compute_dtype):
    """One epoch of K3's plain version on the order-free case → (params,
    metrics)."""
    return fs._fused_scale_call_plain(plist, packed, 0, CFG, EXACT_LW, 1, EXACT_LR,
                                      EXACT_TILE, n_valid, compute_dtype, "packed", None)


def exact_k3_kernel(plist, packed, n_valid, compute_dtype):
    """One epoch of K3 on the order-free case → (params, metrics)."""
    return fs._fused_scale_call(plist, packed, 0, CFG, EXACT_LW, 1, EXACT_LR, EXACT_TILE,
                                n_valid, compute_dtype, "packed", None)


def exact_k3_row(kernel, plain):
    """K3 and its plain version on the order-free case → (row, bit for
    bit): the params, and the loss row."""
    (pk, mk), (pp, mp) = kernel, plain
    unequal = [n for i, n in enumerate(ft._LAYERS)
               for q, j in (("w", 2 * i), ("b", 2 * i + 1)) if not torch.equal(pk[j], pp[j])]
    ok = not unequal and torch.equal(mk[:, :5], mp[:, :5])
    return {"bits_equal": ok, "unequal_arrays": unequal,
            "row_kernel": mk[0, :5].tolist(), "row_plain": mp[0, :5].tolist()}, ok


def order_free_self_check(dev, seeds=4):
    """The plain version on the order-free case against itself with its
    hidden units and its valid rows permuted: equal bit for bit, or the case
    is not order-free.  → {dtype: bool}."""
    out = {}
    for cd in (None, "bfloat16"):
        plist, packed, nv = exact_case(dev, cd)
        gref, rref = exact_plain(plist, packed, nv, cd)
        same = True
        v = torch.tensor(list(EXACT_VALID))
        for s in range(seeds):
            perms = perms_of(s, dev)
            g, r = exact_plain(permute(plist, perms), packed, nv, cd)
            same &= all(torch.equal(a, b) for a, b in zip(g, permute(gref, perms)))
            idx = torch.arange(packed.shape[0])
            idx[v] = v[torch.randperm(len(v), generator=torch.Generator().manual_seed(s))]
            g2, r2 = exact_plain(plist, packed[idx.to(dev)], nv, cd)
            same &= all(torch.equal(a, b) for a, b in zip(g2, gref))
            same &= torch.equal(r, rref) and torch.equal(r2, rref)
        out["float32" if cd is None else cd] = bool(same)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8, help="permutations a case")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rows = []
    for case in K3_CASES:
        rows += k3_case(*case, args.seeds, dev)
    rows.append(k4_case(args.seeds, dev))
    print(json.dumps({"k3_order_noise": {"seeds": args.seeds, "device": str(dev),
                                         "rows": rows, "seconds": time.perf_counter() - t0}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
