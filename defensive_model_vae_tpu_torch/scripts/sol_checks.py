"""P1-sol's two checks against its plain version, and the spread that sets
the second one's limit:

    python -m defensive_model_vae_tpu_torch.scripts.sol_checks [--device cpu]

P1-sol's total passes through 23 products whose outputs are rounded to
bf16, so the total alone cannot tell another summation order (which sends
some intermediates to the neighbouring bf16 value) from a missing rounding.
Two checks hold the function instead:

(a) an order-free case (:func:`exact_case`): ``w_in`` with one ±1 a column,
    ``w_chain`` a signed permutation scaled by 0.75, rows of integers in
    [-8, 8].  Every product output is one exact term whatever the order,
    and the rounding still fires (0.75 = 3/4 of an 8-bit mantissa needs 10
    bits); at :func:`exact_rows`' row count every partial sum of the total
    is exact in float32, so kernel and plain version must agree bit for
    bit, and both deliberate errors (:func:`wrong_sums`) miss that equality.
    The count is rounded down to a multiple of 4, not of the kernel's
    64-row tile, so its last tile is ragged (188 rows: two full tiles and
    one of 60, whose 4,920 bytes end 8 bytes past a 16-byte chunk);
(b) the random case within ``ORDER_TOL`` (by row count) of Σ|terms|: twice
    the largest gap of the plain version against itself with the hidden
    index permuted (:func:`order_noise`: the same function summed in
    another order), over ``ORDER_SEEDS`` permutations, on the corpora the
    checks use (``CORPORA``).

This script prints, as one JSON line, each corpus's spread (largest gap,
twice it, the limit in ``ORDER_TOL``, the deliberate errors' gaps) and the
order-free case (its row count, the plain total against the float64 sum of
its terms, the deliberate errors' totals).  On the card the plain version
runs on cuBLAS, here on the CPU: ``ORDER_TOL`` holds twice the CPU's spread.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig
from ..ops import fused_scale as fs
from ..ops import scale_ablation as sa
from .scale_ablation import scale_corpus

EXACT_VALUES, EXACT_SCALE, EXACT_MULTIPLE = tuple(range(-8, 9)), 0.75, 4
KERNEL_ROWS = 64  # the rows of the kernel's tile (csrc/p1_sol.cu, TM)
ORDER_SEEDS = tuple(range(32))
# the corpora the checks hold P1-sol on: (rows, scale_corpus seed, ε seed,
# tile); the first two are chip_smoke.py's phases 17 and 18, the third
# tests/test_torch_ablation_card.py's
CORPORA = ((8448, 0, 1, 352), (131072, 0, 7, 2048), (8448, 3, 1, 352))
# twice the largest CPU gap over ORDER_SEEDS on CORPORA, by row count (this
# script with --device cpu: 3.90e-6 at 8,448 rows, corpus seed 0; 3.24e-6
# at seed 3; 1.07e-6 at 131,072), rounded up in the third digit
ORDER_TOL = {8448: 7.81e-6, 131072: 2.14e-6}


def chip_weights(width, dev):
    """The random case's weights in chip_smoke.py and the card tests:
    N(0, 1/width) and N(0, 1/128) from torch seed 5, in bf16."""
    g = torch.Generator().manual_seed(5)
    w_in = (torch.randn((width, 128), generator=g) / width ** 0.5).to(torch.bfloat16)
    w_ch = (torch.randn((128, 128), generator=g) / 128 ** 0.5).to(torch.bfloat16)
    return w_in.to(dev), w_ch.to(dev)


def corpus(rows, seed, eps_seed, tile, dev, cfg=CVAEConfig()):
    """A packed bf16 corpus as the checks make it: scale_corpus(rows, seed)
    with N(0, 1) ε from ``eps_seed``."""
    eps = np.random.default_rng(eps_seed).standard_normal((rows, cfg.latent_dim))
    _, packed = fs._scale_inputs(scale_corpus(rows, seed=seed), cfg, tile, "bfloat16",
                                 eps.astype(np.float32), dev)
    return packed


def _low_bit(v):
    """The exponent of the lowest set bit of the nonzero float ``v``."""
    m, e = math.frexp(abs(v))
    i = int(m * 2 ** 53)
    return e - 53 + (i & -i).bit_length() - 1


def exact_weights(width, dev, seed=0):
    """Check (a)'s weights: w_in with one ±1 a column (unit n reads input
    column k(n), each column feeding two or three units), w_chain a signed
    permutation scaled by EXACT_SCALE; both bf16."""
    rng = np.random.default_rng(seed)
    cols = np.arange(128)
    w_in = np.zeros((width, 128), np.float32)
    w_in[rng.permutation(cols % width), cols] = rng.choice([-1.0, 1.0], 128)
    w_ch = np.zeros((128, 128), np.float32)
    w_ch[rng.permutation(128), cols] = rng.choice([-1.0, 1.0], 128) * EXACT_SCALE
    return (torch.tensor(w_in).to(torch.bfloat16).to(dev),
            torch.tensor(w_ch).to(torch.bfloat16).to(dev))


def exact_rows(w_in, w_ch, n_chain):
    """The most rows at which every partial sum of check (a)'s total is exact
    in float32, in any order.  Each unit's last h depends on one input value
    v in EXACT_VALUES: F_n(v), found by the plain chain on rows of one value
    each (exact: every product one term).  Every term is a multiple of q,
    the largest power of two dividing every nonzero F_n(v), and a row adds
    at most M = Σ_n max_v |F_n(v)|; so every partial sum over n rows is a
    multiple of q below n·M, exact while n·M ≤ 2^24·q."""
    vals = torch.tensor(EXACT_VALUES, dtype=torch.float32, device=w_in.device)
    x = vals[:, None].expand(len(vals), w_in.shape[0]).to(torch.bfloat16).contiguous()
    f = sa._sol_h(x, w_in, w_ch, n_chain).double().cpu()
    q = 2.0 ** min(_low_bit(v) for v in f[f != 0].tolist())
    m = float(f.abs().max(dim=0).values.sum())
    return int(2 ** 24 * q // m)


def exact_case(dev, n_chain, width=41, seed=0, multiple=EXACT_MULTIPLE):
    """Check (a)'s inputs → (packed, w_in, w_ch, rows, the most rows): rows
    of integers from EXACT_VALUES, the most that keep every partial sum
    exact (:func:`exact_rows`) rounded down to a multiple of ``multiple``."""
    w_in, w_ch = exact_weights(width, dev, seed)
    most = exact_rows(w_in, w_ch, n_chain)
    rows = most // multiple * multiple
    x = np.random.default_rng(seed + 1).choice(EXACT_VALUES, (rows, width))
    packed = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).to(dev).contiguous()
    return packed, w_in, w_ch, rows, most


def wrong_sums(packed, w_in, w_ch, n_chain):
    """The total of the plain version with one deliberate error each: {what
    is wrong: the total}."""
    h = packed.float() @ w_in.float()
    for _ in range(n_chain):
        h = h @ w_ch.float()
    return {"one_product_fewer": float(sa._sol_h(packed, w_in, w_ch, n_chain - 1).sum()),
            "no_bf16_rounding": float(h.sum())}


def order_noise(packed, w_in, w_ch, n_chain, tile):
    """The plain version against itself with the hidden index permuted (the
    same function, every product summed in another order), for each
    permutation seed of ORDER_SEEDS → (the largest gap as a fraction of
    Σ|terms|, each seed's gap)."""
    ref = float(sa._p1_sol_plain(packed, w_in, w_ch, n_chain, 1, tile)[0, 0])
    terms = float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
    gaps = []
    for s in ORDER_SEEDS:
        p = torch.randperm(128, generator=torch.Generator().manual_seed(s)).to(packed.device)
        moved = sa._p1_sol_plain(packed, w_in[:, p], w_ch[p][:, p], n_chain, 1, tile)
        gaps.append(abs(float(moved[0, 0]) - ref) / terms)
    return max(gaps), gaps


def check(kernel_fn, packed, w_in, w_ch, n_chain, tile, epochs, exact):
    """Both checks of ``kernel_fn(packed, w_in, w_ch, n_chain, epochs,
    tile)`` (P1-sol's wrapper): (a) on the order-free case ``exact`` (from
    :func:`exact_case`) and (b) on ``packed`` → (row, within both, every
    deliberate error caught)."""
    xp, xw_in, xw_ch, rows, most = exact
    # one tile of all the rows: the total is exact in any tiling
    k = kernel_fn(xp, xw_in, xw_ch, n_chain, epochs, rows)
    p = sa._p1_sol_plain(xp, xw_in, xw_ch, n_chain, epochs, rows)
    plain_sum = float(p[0, 0])
    wrong = wrong_sums(xp, xw_in, xw_ch, n_chain)
    exact_row = {"rows": rows, "rows_max": most,
                 "last_tile_rows": rows - (rows - 1) // KERNEL_ROWS * KERNEL_ROWS,
                 "kernel_sum": float(k[0, 0]),
                 "plain_sum": plain_sum, "bits_equal": bool(torch.equal(k, p)),
                 "wrong_sums": wrong,
                 "wrong_equal": {w: v == plain_sum for w, v in wrong.items()}}
    k = kernel_fn(packed, w_in, w_ch, n_chain, epochs, tile)
    p = sa._p1_sol_plain(packed, w_in, w_ch, n_chain, epochs, tile)
    terms = float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
    tol = ORDER_TOL[packed.shape[0]]
    spread, _ = order_noise(packed, w_in, w_ch, n_chain, tile)
    gap = float((k[:, 0] - p[:, 0]).abs().max())
    ref = float(p[0, 0])
    order_row = {"rows": packed.shape[0], "kernel_sum": float(k[0, 0]), "plain_sum": ref,
                 "sum_gap": gap, "abs_terms": terms, "gap_frac": gap / terms,
                 "tol_frac": tol, "spread_frac": spread, "spread_seeds": len(ORDER_SEEDS),
                 "wrong_gaps_frac": {w: abs(v - ref) / terms
                                     for w, v in wrong_sums(packed, w_in, w_ch,
                                                            n_chain).items()}}
    row = {"order_free": exact_row, "order": order_row,
           "epochs_equal": bool(torch.equal(k[0], k[-1]))}
    ok = (exact_row["bits_equal"] and order_row["gap_frac"] <= tol and spread <= tol
          and row["epochs_equal"])
    caught = (not any(exact_row["wrong_equal"].values())
              and order_row["wrong_gaps_frac"]["one_product_fewer"] > tol)
    return row, ok, caught


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_chain = sa.sol_chain_length(CVAEConfig())
    out = {"device": str(dev), "seeds": len(ORDER_SEEDS), "corpora": []}
    for rows, seed, eps_seed, tile in CORPORA:
        packed = corpus(rows, seed, eps_seed, tile, dev)
        w_in, w_ch = chip_weights(packed.shape[1], dev)
        worst, gaps = order_noise(packed, w_in, w_ch, n_chain, tile)
        ref = float(sa._p1_sol_plain(packed, w_in, w_ch, n_chain, 1, tile)[0, 0])
        terms = float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
        out["corpora"].append({
            "rows": rows, "corpus_seed": seed, "eps_seed": eps_seed, "tile": tile,
            "spread_frac": worst, "twice_spread": 2 * worst, "tol_frac": ORDER_TOL[rows],
            "gaps": gaps, "wrong_gaps_frac": {
                w: abs(v - ref) / terms
                for w, v in wrong_sums(packed, w_in, w_ch, n_chain).items()}})
    xp, xw_in, xw_ch, rows, most = exact_case(dev, n_chain)
    plain = float(sa._p1_sol_plain(xp, xw_in, xw_ch, n_chain, 1, rows)[0, 0])
    exact = float(sa._sol_h(xp, xw_in, xw_ch, n_chain).double().sum())
    out["order_free"] = {"rows": rows, "rows_max": most, "plain_sum": plain,
                         "float64_sum": exact, "exact": plain == exact,
                         "wrong_sums": wrong_sums(xp, xw_in, xw_ch, n_chain)}
    print(json.dumps({"sol_checks": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
