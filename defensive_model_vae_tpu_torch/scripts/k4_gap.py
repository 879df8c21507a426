"""K4 float32 against its plain version at 9,000 rows, tiles of 352: which
rows, which units, and whose order carry the gap.

    python -m defensive_model_vae_tpu_torch.scripts.k4_gap [--noise prng hbm]

The case is ``tests/test_torch_scale_card.py``'s
``test_engine_k3_and_k4_match_plain_at_ragged_chunks[None-<noise>-352]``:
the same corpus, parameters and stream base.  For each noise mode:

1. K4 (``_grad_epoch_call``) and ``_plain_grad_epoch`` on the whole
   corpus: each array's gap as a fraction of its max (``K4_TOL`` 1e-5).
2. The rows that carry the gap: rows are left out of both sides through
   the mask column (column 32), and a set of rows is split in halves while
   the rows it keeps still give a gap over ``--row-frac`` of the whole
   corpus's array max.
3. For each such row, alone in the corpus: the unit whose derivative
   differs — the first array in backward order (dec_3's bias, then the
   decoder's, the encoder's and the condition's) whose gap exceeds 1e-3
   of its max.  A gap in dec_3's bias on a time column is the time hinge.
4. That row's forward, three ways: the plain version's float32 (its own
   products, on the card, at the tile's shape), float64 (the margin of
   each unit from 0 in ulps of float32 at Σ|terms|), and the kernel's
   stated order emulated in torch on the CPU (every float32 output one
   FMA chain over k in order from 0, then + bias; z = fma(ε, σ, μ);
   each FMA is the float64 product, exact, plus the float64 accumulator,
   rounded to float32 — a double rounding that can differ from one FMA
   at an exact float32 tie only).  σ and, with prng, ε are computed on
   the card (CUDA's ``expf``, ``logf``, ``cosf`` as the kernel calls
   them).
5. With prng, the plain version fed the ε drawn on the card instead of
   on the CPU: whether the gap stays.

Prints one JSON line.  Needs the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_scale as fs
from ..ops import fused_trainer as ft

CFG = CVAEConfig()
LW = LossWeights()
N, TILE, STREAM = 9000, 352, 4
K4_TOL = 1e-5
F, C, Z, D = 30, 2, 8, 3
MASK_COL = F + C
# the relu layers in backward order (dec_3 has the time hinge instead)
_BACKWARD = ("dec_3", "dec_2", "dec_1", "dec_0", "enc_3", "enc_2", "enc_1", "enc_0",
             "cond_1", "cond_0")


def corpus(n, seed=3):
    """The card test's corpus (``tests/test_torch_scale_card.py::_corpus``)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


def inputs(dev, noise):
    nv, packed = fs._scale_inputs(corpus(N), CFG, TILE, None, None, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    eps_all = fs.hbm_noise(4, 1, packed.shape[0], 8, None, dev) if noise == "hbm" else None
    return plist, packed, float(nv), eps_all


def eps_of(noise, packed, eps_all, dev, on_card=False):
    if noise == "prng" and on_card:
        return lambda i, blk: ft.philox_normal_on(STREAM + i, 0, TILE, Z, dev)
    return fs._eps_source(noise, CFG, TILE, packed.shape[0], eps_all, STREAM, dev)


def both(plist, packed, nv, noise, eps_all, keep=None, on_card=False):
    """(kernel grads, plain grads) with only the rows in ``keep`` live."""
    if keep is not None:
        packed = packed.clone()
        live = torch.zeros(packed.shape[0], dtype=torch.bool, device=packed.device)
        live[keep] = True
        packed[~live, MASK_COL] = 0.0
    gk, _ = fs._grad_epoch_call(plist, packed, STREAM, CFG, LW, TILE, nv, None, noise,
                                eps_all)
    gp, _ = fs._plain_grad_epoch(plist, packed, TILE, CFG, LW, nv, None,
                                 eps_of(noise, packed, eps_all, packed.device, on_card))
    return gk, gp


def gaps(gk, gp, ref_max):
    return [float((a - b).abs().max()) / m for a, b, m in zip(gk, gp, ref_max)]


def carriers(plist, packed, nv, noise, eps_all, ref_max, frac):
    """Rows whose set, kept alone, still gives a gap over ``frac``."""
    calls = [0]

    def over(rows):
        calls[0] += 1
        return max(gaps(*both(plist, packed, nv, noise, eps_all, rows), ref_max)) > frac

    def search(rows):
        if not over(rows):
            return []
        if len(rows) == 1:
            return rows
        h = len(rows) // 2
        return search(rows[:h]) + search(rows[h:])

    live = torch.nonzero(packed[:, MASK_COL] > 0).flatten().tolist()
    return search(live), calls[0]


def flipped_unit(gk, gp):
    """The first array in backward order whose gap is over 1e-3 of its max:
    (layer, unit, gap) from the bias gradients of a one-row run."""
    names = ft._LAYERS
    for layer in _BACKWARD:
        i = names.index(layer)
        a, b = gk[2 * i + 1].flatten(), gp[2 * i + 1].flatten()
        d = (a - b).abs()
        scale = max(float(b.abs().max()), float(a.abs().max()), 1e-30)
        if float(d.max()) > 1e-3 * scale:
            j = int(d.argmax())
            return {"layer": layer, "unit": j, "bias_gap": float(d[j]),
                    "kernel": float(a[j]), "plain": float(b[j]),
                    "units_over": int((d > 1e-3 * scale).sum())}
    return None


def fma_chain(a, w):
    """float32 outputs, each one FMA chain over k in order from 0: a (K,),
    w (K, N) float32 CPU tensors."""
    acc = torch.zeros(w.shape[1], dtype=torch.float32)
    for k in range(w.shape[0]):
        acc = (a[k].double() * w[k].double() + acc.double()).float()
    return acc


def forward_three_ways(plist, packed, eps_tile, eps_kernel_row, r, dev):
    """Pre-activations of row r: plain float32 (at the tile's shape, on
    the card), float64 and the kernel's order emulated on the CPU, with
    Σ|terms| per unit."""
    p = {n: (plist[2 * i], plist[2 * i + 1]) for i, n in enumerate(ft._LAYERS)}
    t0 = (r // TILE) * TILE
    blk = packed[t0:t0 + TILE]
    x, cond, eps = blk[:, :F], blk[:, F:F + C], eps_tile
    pre = {}
    c0 = torch.relu(cond @ p["cond_0"][0] + p["cond_0"][1])
    pre["cond_0"] = cond @ p["cond_0"][0] + p["cond_0"][1]
    pre["cond_1"] = c0 @ p["cond_1"][0] + p["cond_1"][1]
    hc = torch.relu(pre["cond_1"])
    h = x
    for n in ("enc_0", "enc_1", "enc_2", "enc_3"):
        pre[n] = h @ p[n][0] + p[n][1]
        h = torch.relu(pre[n])
    hcat = torch.cat([h, hc], dim=1)
    w_ml = torch.cat([p["fc_mu"][0], p["fc_logvar"][0]], dim=1)
    b_ml = torch.cat([p["fc_mu"][1], p["fc_logvar"][1]], dim=1)
    ml = hcat @ w_ml + b_ml
    mu, lv = ml[:, :Z], ml[:, Z:]
    std = torch.exp(0.5 * lv)
    z = mu + eps * std
    g = torch.cat([z, hc], dim=1)
    for n in ("dec_0", "dec_1", "dec_2"):
        pre[n] = g @ p[n][0] + p[n][1]
        g = torch.relu(pre[n])
    pre["dec_3"] = g @ p["dec_3"][0] + p["dec_3"][1]
    plain = {k: v[r - t0].cpu() for k, v in pre.items()}

    # float64 and the kernel's order, on the CPU, from the same float32 inputs
    cpu = {n: (p[n][0].cpu(), p[n][1].cpu().flatten()) for n in p}
    xr, cr = x[r - t0].cpu(), cond[r - t0].cpu()
    ek = eps_kernel_row.cpu()

    def run(prod, z_of):
        out, mags = {}, {}

        def lin(n, a, w=None, b=None):
            w = cpu[n][0] if w is None else w
            b = cpu[n][1] if b is None else b
            out[n] = prod(a, w, b)
            mags[n] = (a.double()[:, None] * w.double()).abs().sum(0) + b.double().abs()
            return out[n]

        a = torch.relu(lin("cond_0", cr))
        hc_ = torch.relu(lin("cond_1", a))
        h_ = xr
        for n in ("enc_0", "enc_1", "enc_2", "enc_3"):
            h_ = torch.relu(lin(n, h_))
        hcat_ = torch.cat([h_, hc_])
        ml_ = prod(hcat_, torch.cat([cpu["fc_mu"][0], cpu["fc_logvar"][0]], 1),
                   torch.cat([cpu["fc_mu"][1], cpu["fc_logvar"][1]]))
        g_ = torch.cat([z_of(ml_), hc_])
        for n in ("dec_0", "dec_1", "dec_2"):
            g_ = torch.relu(lin(n, g_))
        lin("dec_3", g_)
        return out, mags

    f64, mags = run(lambda a, w, b: a.double() @ w.double() + b.double(),
                    lambda ml_: ml_[:Z] + ek.double() * torch.exp(0.5 * ml_[Z:]))
    # σ in the emulation is CUDA's expf of the emulated logσ²/2
    def z_kernel(ml_):
        sd = torch.exp(0.5 * ml_[Z:].to(dev)).cpu()
        return (ek.double() * sd.double() + ml_[:Z].double()).float()

    emu, _ = run(lambda a, w, b: fma_chain(a, w) + b, z_kernel)
    return plain, f64, emu, mags


def ulps_at(x64, mag):
    """|x| in ulps of float32 at the magnitude ``mag``."""
    sp = np.spacing(np.float32(max(float(mag), 1e-38)))
    return float(abs(float(x64)) / sp)


def describe(unit, plain, f64, emu, mags):
    """The flipped unit's pre-activation each way, or the time hinge's
    difference, and whether the emulated order gives the kernel's side."""
    layer, j = unit["layer"], unit["unit"]
    if layer == "dec_3":
        # bias gap on a time column f = D·i: the hinge between i-1, i or i, i+1
        i = j // D
        pairs = [(i - 1, i), (i, i + 1)]
        best = None
        for a, b in pairs:
            if a < 0 or b >= CFG.seq_len:
                continue
            ia, ib = D * a, D * b
            vals = {k: float(v[ib] - v[ia]) for k, v in
                    (("plain", plain["dec_3"]), ("f64", f64["dec_3"]), ("emu", emu["dec_3"]))}
            mag = float(mags["dec_3"][ia] + mags["dec_3"][ib])
            cand = {"what": f"time difference recon[{ib}] - recon[{ia}]", **vals,
                    "margin_ulps": ulps_at(vals["f64"], mag), "sum_abs_terms": mag}
            if best is None or abs(vals["f64"]) < abs(best["f64"]):
                best = cand
        out = best
    else:
        out = {"what": f"{layer} pre-activation unit {j}",
               "plain": float(plain[layer][j]), "f64": float(f64[layer][j]),
               "emu": float(emu[layer][j]), "sum_abs_terms": float(mags[layer][j]),
               "margin_ulps": ulps_at(f64[layer][j], mags[layer][j])}
    out["plain_sign"] = out["plain"] > 0
    out["emu_sign"] = out["emu"] > 0
    # the kernel's side is the other one: its gradient differs there
    out["emulation_gives_kernel_side"] = out["emu_sign"] != out["plain_sign"]
    return out


def flips_by_emulation(plain, emu):
    """Every unit whose sign differs between the plain and emulated
    float32 pre-activations (and the time differences)."""
    out = []
    for n in _BACKWARD[1:]:
        d = torch.nonzero((plain[n] > 0) != (emu[n] > 0)).flatten().tolist()
        out += [f"{n}[{j}]" for j in d]
    td_p = plain["dec_3"][D::D] - plain["dec_3"][0:F - D:D]
    td_e = emu["dec_3"][D::D] - emu["dec_3"][0:F - D:D]
    out += [f"tdiff[{j}]" for j in torch.nonzero((td_p < 0) != (td_e < 0)).flatten().tolist()]
    return out


def run_case(noise, dev, frac):
    plist, packed, nv, eps_all = inputs(dev, noise)
    gk, gp = both(plist, packed, nv, noise, eps_all)
    ref_max = [max(float(b.abs().max()), 1e-12) for b in gp]
    full = gaps(gk, gp, ref_max)
    worst = int(np.argmax(full))
    out = {"noise": noise, "gap_max": max(full), "over_K4_TOL": max(full) > K4_TOL,
           "worst_array": f"{ft._LAYERS[worst // 2]}.{'wb'[worst % 2]}"}
    if noise == "prng":
        card = ft.philox_normal_on(STREAM, 0, TILE, Z, dev)
        cpu = ft.philox_normal(STREAM, 0, TILE, Z, dev)
        out["eps_card_vs_cpu"] = {"max_abs": float((card - cpu).abs().max()),
                                  "differ": int((card != cpu).sum()), "of": card.numel()}
        out["gap_max_plain_eps_on_card"] = max(gaps(*both(plist, packed, nv, noise, eps_all,
                                                           on_card=True), ref_max))
    if max(full) <= frac:
        return out
    rows, calls = carriers(plist, packed, nv, noise, eps_all, ref_max, frac)
    out["carriers"], out["search_calls"] = rows, calls
    if rows:
        rest = [r for r in torch.nonzero(packed[:, MASK_COL] > 0).flatten().tolist()
                if r not in set(rows)]
        out["gap_without_carriers"] = max(gaps(*both(plist, packed, nv, noise, eps_all, rest),
                                               ref_max))
    out["rows"] = []
    for r in rows:
        gk1, gp1 = both(plist, packed, nv, noise, eps_all, [r])
        unit = flipped_unit(gk1, gp1)
        t0 = (r // TILE) * TILE
        eps_plain = eps_of(noise, packed, eps_all, dev)(r // TILE, packed[t0:t0 + TILE])
        eps_kernel = (ft.philox_normal_on(STREAM + r // TILE, 0, TILE, Z, dev) if noise == "prng"
                      else eps_plain)
        plain, f64, emu, mags = forward_three_ways(plist, packed, eps_plain, eps_kernel[r - t0],
                                                      r, dev)
        entry = {"row": r, "unit": unit, "emulated_flips": flips_by_emulation(plain, emu)}
        if unit is not None:
            entry["pre_activation"] = describe(unit, plain, f64, emu, mags)
        out["rows"].append(entry)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", nargs="+", default=["prng", "hbm"])
    ap.add_argument("--row-frac", type=float, default=K4_TOL / 2,
                    help="a kept set carries the gap while its gap is over this "
                         "fraction of the whole corpus's array max")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "cases": [run_case(n, dev, args.row_frac) for n in args.noise]}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
