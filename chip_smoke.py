#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its name and seconds, each under
a watchdog (``faulthandler.dump_traceback_later``) that turns a hang into a
traceback and a non-zero exit:

1. ``device``      torch, CUDA, the card, ``nvidia-smi``, ``nvcc``, triton;
2. ``build``       ``nvcc`` builds every kernel of the port, all at once,
                   beside the cache probe's rounds A and A2, P3 (built,
                   launched, held against x * 2 + 1 bit for bit) and round
                   B (``scripts/cache_probe.py``); the tensor-core
                   instructions of K3/K4's library counted (``cuobjdump``);
3. ``cache_probe`` the probe's verdicts for each object; P3 timed in
                   turns with ``torch.add`` through its wrapper and on the
                   device alone (calls replayed from a CUDA graph, every
                   output bit for bit x * 2 + 1); the host split of a call;
4. ``k1_vs_plain`` kernel K1 against its plain torch version on the card
                   (explicit ε, sce2 B=16 and sce4 B=134, 1 and 50 epochs);
5. ``train``       the main path: ``fused_train`` on sce4 at full width
                   (134 windows, H=128, 3000 epochs) in one K1 launch (one
                   thread-block cluster), its time against the plain
                   version's, a checkpoint round trip; one more run of 300
                   epochs with the phase timer for K1's phase split;
6. ``sample``      one trajectory per sce4 start point, with re-draws;
7. ``track``       the samples tracked by the batched MPC, and the SLSQP
                   golden windows held to the bands of tests/test_mpc.py;
8. ``k3_vs_plain`` kernels K3 and K4 against their plain torch versions on
                   the card (f32 and bf16, packed, hbm and prng noise, ragged
                   corpora, blocks of one 32-row step and of several);
9. ``train_scale`` the production-scale path at the bench shape:
                   ``fused_train_scale`` on 131,072 windows, 200 epochs, tile
                   2048, bf16, hbm noise, in one K3 call; K3's time against
                   the plain version's, and K3 held against it over the
                   first 10 epochs; a float32 run; a per-epoch
                   ``fused_train_scale_dp`` run through K4; K4 timed and held
                   against its plain version; a checkpoint round trip;
10. ``k2_vs_plain`` kernel K2 against its plain (padded and masked) torch
                   version on the card: the four fixture corpora, explicit ε,
                   1 and 50 epochs; and K1 on a grid of 4 seeds against K1's
                   plain version once per seed;
11. ``multi``      the path that trains every scenario's model:
                   ``fused_train_multi`` on the four corpora at 3000 epochs
                   in one K2 launch, each scenario converging (last <
                   first/5); K2 timed against its plain version; at 300
                   epochs each scenario held against ``fused_train`` with
                   seed + i; each model sampled and tracked with its
                   scenario's tracker, controls within bounds;
12. ``track_multi`` ``generate_and_track_multi_from_starts`` with 4
                   generation seeds on the sce2 model, row by row against
                   per-seed ``generate_and_track_from_starts``;
13. ``seeds``      the seed sweep: ``fused_train_seeds`` on sce4, 32 seeds ×
                   3000 epochs in one launch of K1 on 32 clusters, every seed
                   converging; timed against the plain version; at 300
                   epochs 4 seeds bit for bit against ``fused_train``;
14. ``ablation_vs_plain`` the K3 ablation's kernels against their plain
                   versions on an 8,448-row bf16 corpus with packed ε (tiles
                   of 352: two 32-row steps a block, one chunk straddling the
                   last tile): K3 under each of its seven ``_ablate`` knobs at
                   1 and 3 epochs (dwT among them), K3 with ``_ablate=()`` and K4 bit for
                   bit their reference digests (``scripts/k3_digest.py``), P1's
                   stream, sol, fwd and dx kernels, sol's and dx's limit
                   held below plain versions with one deliberate error; P2
                   at the full 200 × 131,072 × 8 bf16 stream, four calls
                   (the second on the stream negated) bit for bit alike,
                   its limit held below plain versions that drop a batch
                   or a block;
15. ``ablation``   the ported ``scripts/scale_ablation.py`` at the bench
                   width (131,072 windows, tile 2048, bf16), 20 epochs, 1
                   warm + 1 timed rep of every variant, its breakdown line;
                   the ported P2 probe's two variants at full shape; every
                   ablation kernel launched (the CUDA launches as the C
                   entries count them; P2 one a call); P2 timed in turns
                   with ``torch.sum`` through its wrapper and on the device
                   alone; P1 held against its plain versions
                   there, as in phase 14, and timed; K3 under dwT held
                   against its plain version over the first 2 epochs;
16. ``train_auto`` K1's autodiff instance on its main path:
                   ``fused_train(backward="auto")`` on sce4 at 3000 epochs,
                   timed, its gap to the manual run printed;
17. ``auto_vs_plain`` the autodiff instances against their plain versions
                   (autograd of ``_forward_loss``): K1-auto at 1 and 50
                   epochs; K1-auto against K1-manual over JAX's 5-epoch run
                   (printed); K2-auto and the seed grid under auto bit for
                   bit K1-auto and against their plain versions, as
                   ``k2_vs_plain``; K3-auto (float32, f32_acts, bf16_chain) at
                   8,448 rows, tiles of 352, 1 and 3 epochs; K4-auto on one
                   tile: every rounded gradient an exact bf16 value (the
                   per-tile rounding; its limit above the plain version's
                   own order noise on three corpora), two wrong plain
                   versions failing that check; K4-auto on three tiles the float32 sum of
                   K4-auto on each tile alone bit for bit, each of those
                   held as one tile is, three wrong plain versions (one
                   rounding only the cross-tile total) failing that check;
                   K3 under dwT bit for bit the default;
18. ``train_scale_auto`` ``train --fused-scale --backward auto`` at the
                   bench shape, prng, bf16 and float32, and a bf16_chain
                   run; each instance's launch timed alone and held against
                   its plain version over its first epochs; the per-epoch
                   tier through K4-auto;
19. ``scan_bf16`` the scan trainer's bf16 chain, ``train_multi_scenario``
                   on the four fixtures and ``train_conditioned`` with one
                   extra condition column, 300 epochs each, every final
                   loss within its band of the float32 run's;
20. ``k1_digest``  ``scripts/k1_digest.py``: K1, K1-auto, K2 and the seed
                   grid (50 and 3000 epochs) bit for bit the one-block
                   build's digests at the picked cluster size, and K1's
                   50-epoch case at each forced size 1, 2, 4, 8 and 16;
21. ``serve``      the serving path (``serving.serve_checkpoint``): the
                   four committed checkpoints behind one local endpoint,
                   batch 16, 512 steps; one /serve to sce4 with 16 sce4
                   starts (every row finite or listed in 'invalid'), the
                   first row alone bit for bit, the answer equal to a direct
                   call of the serve program, each row's device reference
                   against the host PathReference (θ 1e-4, v 0.05), its
                   states against the same waypoints tracked through the
                   host reference (atol 1e-3), row 0 against its waypoints
                   (mean < 2 m; every row's mean printed), one /generate
                   to sce1 as npz; each request's wall time, the program's
                   CUDA-event time, its device kernels' time (torch.profiler
                   over 4 and 8 steps, extrapolated to 512) and the host
                   share.  No kernel of the port is on this path;
22. ``kernels``    one line listing every ported kernel with its launches on
                   its main path, its error, times and bound (P2 and P3 also
                   their device times, their library call's both ways, and
                   the spread of each; the K1 family its cluster size, its
                   bound over the cluster's SMs and its phase split).

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the port beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "defensive_model_vae_tpu_torch"

# the serve phase: the README's deployment (the four committed models behind
# one endpoint, batch 16), the CLI's 512 steps, dt 0.02, P = 30, M = 20; the
# reference held to tests/test_mpc.py:248-249's bounds, the tracking to
# :290's
SERVE_BATCH, SERVE_STEPS, SERVE_DT = 16, 512, 0.02
SERVE_SEED = 5
# the steps of the two profiled runs whose difference gives a step's
# device time (the profiler's cost grows with the kernels it records)
SERVE_PROFILE_STEPS = (4, 8)
SERVE_THETA_TOL, SERVE_V_TOL, SERVE_POS_MEAN_M = 1e-4, 0.05, 2.0
# the served states against the same waypoints tracked through the host
# PathReference: the tracker's whole-simulation tolerance
SERVE_HOST_TRACK_TOL = 1e-3

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# bf16 dense on the tensor cores, HBM
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

# K1 against its plain version, explicit ε (stated tolerances):
# - metrics rows: relative error; one epoch differs only by summation order
#   (1e-5), fifty epochs compound it through Adam (1e-3);
# - final params: absolute error.  Adam's step is lr·m̂/(√v̂+1e-8), about
#   ±lr = 1e-3 whatever |g| is, so an element whose gradient sits at the
#   rounding-noise level of the two summation orders can step the other
#   way: after one epoch that moves no element by 1e-4 (a tenth of a
#   step); after fifty, ten opposite steps bound it (1e-2).  The metrics
#   rows, which see every parameter, carry the tight check there.
K1_TOL = {1: {"params_abs": 1e-4, "metrics_rel": 1e-5},
          50: {"params_abs": 1e-2, "metrics_rel": 1e-3}}
# K2 and the seed grid against their plain versions: K1_TOL's numbers.  But
# after fifty epochs a loss component that nears zero (the start loss, or the
# hinge sum of the time loss) is chaotic: one float32 ulp on the initial
# params moves it by up to 6e-2 of itself on the plain version alone, while
# the total moves by 2e-4 (k2_vs_plain measures this beside each 50-epoch
# row, "plain_one_ulp").  So there each component's gap is held against its
# row's total loss, which the weighted components sum to; after one epoch
# against the component itself, as K1's rows.
GRID_TOL = {1: {**K1_TOL[1], "metrics_vs": "component"},
            50: {**K1_TOL[50], "metrics_vs": "total"}}

# K3 against its plain version, same inputs and the same ε on both (stated
# tolerances), by three numbers:
# - params_abs, the largest gap of any parameter.  Each epoch moves a
#   parameter by Adam's lr·m̂/(√v̂+1e-8), at most lr = 1e-3, so after E
#   epochs two runs can differ by at most 2·E·lr: every bound below is a
#   small part of one step, or (bf16, several epochs) of the travel;
# - params_frac, the largest share of one array's elements whose gap is
#   over a tenth of a step (STEP_TENTH): a wrong gradient in any one array
#   moves most of that array's elements apart;
# - metrics_rel, the loss rows, which see every parameter.
# float32: summation order only (32-row steps summed chunk by chunk against
# tile-sized products): no element may take a step the other way.  One
# epoch's step is lr·sign(g) wherever |g| is above the noise, so its
# gap is float32 rounding of the params (1e-5).  bf16: both round the same
# float32 values to bf16, but an activation one float32 ulp apart can round
# to the neighbouring bf16 value (2^-8 relative) and a gradient near zero
# then changes sign; from the second epoch on, a few elements of an array
# take steps the other way.
STEP_TENTH = 1e-4
K3_TOL = {(None, 1): {"params_abs": 1e-5, "params_frac": 0.0, "metrics_rel": 1e-5},
          (None, 5): {"params_abs": 1e-4, "params_frac": 0.0, "metrics_rel": 1e-4},
          (None, 20): {"params_abs": 1e-4, "params_frac": 0.0, "metrics_rel": 1e-4},
          ("bfloat16", 1): {"params_abs": 1e-5, "params_frac": 0.0, "metrics_rel": 1e-5},
          ("bfloat16", 10): {"params_abs": 5e-3, "params_frac": 0.05, "metrics_rel": 1e-3},
          ("bfloat16", 20): {"params_abs": 5e-3, "params_frac": 0.05, "metrics_rel": 1e-3}}
# three epochs under an ablation knob (ablation_vs_plain), or two at the
# bench width (ablation): the ten-epoch row's numbers, since from the
# second epoch on a few elements can take steps the other way, as above
K3_TOL[("bfloat16", 3)] = K3_TOL[("bfloat16", 2)] = K3_TOL[("bfloat16", 10)]
# float32 over three epochs (the autodiff instances): the five-epoch row's
# numbers hold for fewer epochs
K3_TOL[(None, 3)] = K3_TOL[(None, 5)]
# noacc: Adam's step reads one tile's gradient sum (352 rows in
# ablation_vs_plain), in which more elements sit at bf16 rounding level than
# in the whole corpus's, and such an element can step the other way each
# epoch: its params are held to that travel (2·E·lr) and to the share of
# elements over a tenth of a step (5%), its gradient itself to K4's rule
NOACC_TOL = {ep: {"params_abs": 2 * ep * 1e-3 + 1e-5, "params_frac": 0.05,
                  "metrics_rel": K3_TOL[("bfloat16", ep)]["metrics_rel"]} for ep in (1, 3)}
# K4 (one epoch's summed gradients): each array to a fraction of its own max
# (float32: summation order; bf16: JAX's own bf16 rule), the loss row relative
K4_TOL = {None: {"grad_rel_max": 1e-5, "row_rel": 1e-5},
          "bfloat16": {"grad_rel_max": 1e-2, "row_rel": 1e-4}}

# the seed sweep of bench.py::bench_seed_grid (:718): 32 seeds of sce4 at
# the reference depth; the plain versions of K1, K2 and the seed grid are
# timed over these epochs (and seeds) on the same inputs and scaled up to the
# kernels' work, which is linear in both
SWEEP_SEEDS, DEPTH = 32, 3000
# (few, to keep the whole command under 300 s)
PLAIN_K1_EPOCHS, PLAIN_MULTI_EPOCHS, PLAIN_SEEDS, PLAIN_SEEDS_EPOCHS = 100, 50, 2, 50
# the bit-for-bit and per-scenario checks of K2 and the seed grid
CHECK_EPOCHS, CHECK_SEEDS = 300, (0, 9, 22, 31)
# the k1_digest phase: K1's 50-epoch case at each forced cluster size
K1_FORCED_SIZES = (1, 2, 4, 8, 16)
# the K1 family's phase split: one more timed launch a kernel, at this
# depth (every epoch runs the same phases, so each phase's share is the
# full run's; its milliseconds are this many epochs')
SPLIT_EPOCHS = 300
# K1, K1-auto, K2 and the seed grid are timed on their main paths' own run,
# so their ``ms`` holds the entry call's host work around the one launch
ENTRY_MS_OF = "the entry call: the inputs' preparation, the launch, the copy back"

# the bench shape of the production-scale trainer (bench.py::bench_scale_fused)
SCALE_N, SCALE_EPOCHS, SCALE_TILE = 131072, 200, 2048
PLAIN_BUDGET_S = 30.0   # the plain version runs the full 200 epochs if it fits
PROBE_EPOCHS = 10       # else these, scaled up; K3 is held against them


# the K3 ablation (phases 13 and 14).  P1 and P2 against their plain
# versions: each sum within a fraction of the sum of the absolute values of
# its terms — float32 sums in another order (stream: 1e-5); fwd's loss
# components rtol 1e-5, as K3's one-epoch rows.  sol's and dx's sums pass
# through chains of products whose float32 sums, taken in another order,
# can round an intermediate to the neighbouring bf16 value; their limit
# lies between the sound runs' gaps and those of plain versions with one
# deliberate error each (p1_wrong_sums), which both phases print and hold
# above it.
ABL_N, ABL_TILE = 8448, 352
ABL_EPOCHS, ABL_REPS, ABL_PLAIN_EPOCHS = 20, 2, 2
P1_TOL = {"stream": 1e-5, "sol": 1e-6, "dx": 1e-6, "fwd_rel": 1e-5}
# P2 at the full stream (P2_EPOCHS x 131,072 x 8, N(0, 1) in bf16): the
# kernel and its plain version are float32 sums of the same 2.1e8 terms in
# two orders, ~1 ulp of the total apart (0.002 at |total| ~ 2.5e4); a
# block of P2_BATCH elements is ~±90, a block's share of the stream ~±450.
# 1e-8 of Σ|terms| (~1.7) lies between: it passes the sound sum with ~850x
# to spare and fails plain versions that drop a batch or a block
# (p2_wrong_sums).
P2_TOL = 1e-8
P2_EPOCHS = 200
P2_BATCH = 8192  # the elements p2_kernel's block takes a step: 256 threads x 4 x 16 bytes

# the autodiff tier (auto_vs_plain).  K4-auto on a one-tile corpus of
# eleven 32-row steps: every rounded gradient an exact bf16 value; the
# float32 sums before the rounding differ only in order, so they round to
# the same or the neighbouring bf16 value (one ulp) — except where an
# upstream cotangent, itself rounded to bf16, rounded the other way and
# the sum cancels (a term's ulp is then many of the sum's): at most
# TILE_FRAC of an array's elements may be over one ulp, and every element
# is held to K4's bf16 rule (1e-2 of its array's max).  TILE_FRAC is twice
# the largest share the plain version puts over one ulp against itself with
# its units reordered (tile_order_noise: three corpora, two orders, both
# styles; 1.51% on the CPU, corpus 1, f32_acts), so a sum taken in another
# order passes on any corpus; the two wrong plain versions put 11.7-62.5%
# over one ulp and round nothing to exact bf16 values.  (It was 1e-3, set
# from the kernel on one corpus.)
TILE_ULPS, TILE_FRAC = 1.0, 0.03
# the corpora (seeds of scale_corpus, ε from seed + 1) and unit orders
# (permutation seeds) of tile_order_noise, the plain version's own
TILE_FRAC_CORPORA, TILE_FRAC_ORDERS = (0, 1, 2), (2, 3)
# K4-auto on three such tiles: its reduce adds the tiles' rounded sums in
# order, and each tile gets one chunk a step whether alone or among three,
# so the result must be the float32 sum of K4-auto on each tile alone, bit
# for bit; each of those must be exact bf16 values within K4's 1e-2 rule of
# the plain version on that tile.  Their gaps in ulps are printed, not held,
# beside the plain version's own against itself with every hidden layer's
# units reordered (the same function, every product summed in another
# order): on these tiles that reordering alone puts several percent of a
# small array's elements over one ulp (cancelling sums, as above), so the
# one-tile rule's TILE_FRAC does not carry over to other corpora
TILES_N = 3
# K3's autodiff instances in bf16 (f32_acts, bf16_chain) round each tile's
# weight gradients to bf16, and a tile's float32 sum one ulp apart can round
# to the neighbouring bf16 value; a gradient summed over many tiles that
# cancels near zero can then change sign from the FIRST epoch on (measured:
# 2.0e-3, one step, at 64 tiles), and its element takes Adam's step (about
# lr) the other way.  So their params are held to that travel (2·E·lr) and
# to the share of elements over a tenth of a step (5%, as K3_TOL's bf16
# rows from the second epoch on); their metrics as K3_TOL's
K3_AUTO_BF16_TOL = {ep: {"params_abs": 2 * ep * 1e-3 + 1e-5, "params_frac": 0.05,
                         "metrics_rel": K3_TOL[("bfloat16", ep)]["metrics_rel"]}
                    for ep in (1, 3)}


def k3_auto_tol(compute_dtype, epochs):
    """The limit of K3's autodiff instance against its plain version."""
    if compute_dtype is None:
        return K3_TOL[(None, epochs)]
    return K3_AUTO_BF16_TOL[epochs]


# K1-auto against K1-manual over JAX's run of tests/test_fused.py:136-167
# (5 epochs, explicit ε, fp reassociation compounding through Adam: 1e-5);
# printed beside the gap of the 3000-epoch main paths, which is chaotic
K1_AUTO_VS_MANUAL = {"epochs": 5, "params_abs": 1e-5}
# K2-auto and the seed grid under auto against K1-auto per run, bit for bit
AUTO_CHECK_EPOCHS = 50
# the autodiff instances held against their plain versions at the bench
# shape over their first epochs, and the per-epoch tier's depth (K4-auto)
AUTO_PROBE_EPOCHS, AUTO_DP_EPOCHS = 1, 20
# the scan trainer's bf16 chain (scan_bf16): each final loss below twice
# the float32 run's (JAX tests/test_model.py:217-235, "on-par
# convergence"), finite and descending
SCAN_EPOCHS, SCAN_BF16_BAND = 300, 2.0
# the cache probe: each round's nvccs, and the phase that waits for them
CACHE_PROBE_ROUND_S = 85.0
# P3 and P2 timed beside their one-call library yardsticks, each in blocks
# taken in turns (kernel, library, library, kernel) TURN_ROUNDS times, so
# each has 2 x TURN_ROUNDS blocks: the median and the spread (min, max).
# Through the wrapper: P3 P3_TIMING_REPS calls a block after as many warm
# ones; P2 P2_WRAPPER_CALLS calls a block.  On the device alone: P3
# P3_GRAPH_CALLS calls captured in one CUDA graph and replayed; P2
# P2_DEVICE_LAUNCHES launches between one pair of events, queued behind a
# spin kernel so the window holds no host work (the 419 MB stream is over
# 8x the 50 MB L2, so no launch finds it cached).  P3's host split: each
# part of a call alone, P3_TIMING_REPS calls a block, host clock.  Ten
# rounds (20 blocks a side, ~2 s in all): with six, P3's median against
# torch.add's moved by ±5% between runs, as the host's clock swings.
TURN_ROUNDS = 10
P3_TIMING_REPS, P3_GRAPH_CALLS = 2000, 1000
P2_WRAPPER_CALLS, P2_DEVICE_LAUNCHES = 3, 20
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's clock: longer than the queueing


def bf16_ulps(got, ref):
    """|got - ref| in units of the bf16 ulp at ``ref`` (ref ≠ 0)."""
    import torch

    _, e = torch.frexp(ref)
    return (got - ref).abs() / torch.ldexp(torch.ones_like(ref), e - 8)


def tile_rounding_gaps(grads, plain, style):
    """One tile's summed gradients against the plain version's under the
    autodiff backward in ``style``: autodiff rounds a tile's weight
    gradients to bf16 (f32_acts, bf16_chain) and its bias gradients
    (bf16_chain), so each of those must be an exact bf16 value and at most
    one bf16 ulp from the plain version's (the float32 sums before the
    rounding differ only in order) → (row, ok)."""
    import torch

    row = {"weights_bf16_exact": True, "biases_bf16_exact": True, "max_ulps": 0.0,
           "frac_unequal": 0.0, "frac_over_ulps": 0.0, "max_rel_to_array_max": 0.0,
           "ulps_tol": TILE_ULPS,
           "frac_tol": TILE_FRAC, "rel_tol": K4_TOL["bfloat16"]["grad_rel_max"],
           "worst_array": None}
    for i, (g, p) in enumerate(zip(grads, plain)):
        weight = i % 2 == 0
        if not (weight or style == "bf16_chain"):
            continue
        key = "weights_bf16_exact" if weight else "biases_bf16_exact"
        row[key] &= bool(torch.equal(g, g.to(torch.bfloat16).float()))
        inf = torch.full_like(g, float("inf"))
        ulps = torch.where(p != 0, bf16_ulps(g, p.where(p != 0, torch.ones_like(p))),
                           torch.where(g != 0, inf, torch.zeros_like(g)))
        row["max_ulps"] = max(row["max_ulps"], float(ulps.max()))
        row["frac_unequal"] = max(row["frac_unequal"], float((g != p).float().mean()))
        frac = float((ulps > TILE_ULPS).float().mean())
        if frac > row["frac_over_ulps"]:  # the array that sets it: index, size, ulps
            row["worst_array"] = [i, g.numel(), float(ulps.max())]
        row["frac_over_ulps"] = max(row["frac_over_ulps"], frac)
        row["max_rel_to_array_max"] = max(row["max_rel_to_array_max"], float(
            (g - p).abs().max() / p.abs().max().clamp(min=1e-30)))
    ok = (row["weights_bf16_exact"] and row["biases_bf16_exact"]
          and row["frac_over_ulps"] <= TILE_FRAC
          and row["max_rel_to_array_max"] <= row["rel_tol"])
    return row, ok


@contextlib.contextmanager
def unrounded_cotangents(ft, params_only=False):
    """Within: ``_forward_loss``'s roundings keep their values but pass
    their cotangents through unrounded (a deliberate error) — with
    ``params_only``, only those of the params (the leaves that autograd
    differentiates), so a tile's weight and bias gradients come out as
    their float32 sums."""
    real = ft.bf16_rounder

    def straight_through(compute_dtype):
        r = real(compute_dtype)
        if params_only:
            return lambda a: (a + (r(a) - a).detach()
                              if a.is_leaf and a.requires_grad else r(a))
        return lambda a: a + (r(a) - a).detach()

    ft.bf16_rounder = straight_through
    try:
        yield
    finally:
        ft.bf16_rounder = real


def wrong_tile_grads(fs, ft, plist, packed, cfg, lw, nv, style, tile=None, cross=False):
    """A packed-ε corpus's gradients (tiles of ``tile`` rows, default one
    tile) from plain versions with one deliberate error each: {what is
    wrong: flat gradients}.  With ``cross`` also the reduce that rounds only
    the cross-tile total of the tiles' float32 sums (on one tile it is the
    right one)."""
    n = packed.shape[0]
    tile = tile or n

    def grads(t):
        src = fs._eps_source("packed", cfg, t, n, None, 0, packed.device)
        return fs._plain_grad_epoch(plist, packed, t, cfg, lw, nv, "bfloat16", src,
                                    backward="auto", mixed_style=style)[0]

    with unrounded_cotangents(ft):
        wrong = {"no_rounding": grads(tile)}
    wrong["rounded_per_32_row_step"] = grads(32)
    if cross:
        with unrounded_cotangents(ft, params_only=True):
            sums = grads(tile)
        r = ft.bf16_rounder("bfloat16")
        wrong["rounded_cross_tile_total"] = [
            r(g) if i % 2 == 0 or style == "bf16_chain" else g for i, g in enumerate(sums)]
    return wrong


def tile_sums(fs, plist, packed, tile, cfg, lw, nv, style):
    """The plain version's rounded gradient sum of each tile alone."""
    src = fs._eps_source("packed", cfg, tile, tile, None, 0, packed.device)
    return [fs._plain_grad_epoch(plist, packed[i:i + tile], tile, cfg, lw, nv, "bfloat16",
                                 src, backward="auto", mixed_style=style)[0]
            for i in range(0, packed.shape[0], tile)]


def tiles_added_gaps(whole, per_tile, plain_tiles, style):
    """Several tiles' summed gradients (``whole``) against the same
    function on each tile alone (``per_tile``, in order): ``whole`` must be
    their float32 sum bit for bit, and each tile alone must hold exact bf16
    values where autodiff rounds and K4's 1e-2 rule against the plain
    version on that tile (``plain_tiles``, from :func:`tile_sums`); the
    rest of :func:`tile_rounding_gaps`'s row is printed → (row, ok)."""
    unequal, count = 0, 0
    for i, g in enumerate(whole):
        added = per_tile[0][i]
        for t in per_tile[1:]:
            added = added + t[i]
        unequal += int((g != added).sum())
        count += g.numel()
    tiles = per_tile_rows(per_tile, plain_tiles, style)
    row = {"tiles": len(per_tile), "added_bit_identical": unequal == 0,
           "added_frac_unequal": unequal / count, "per_tile": tiles,
           "per_tile_pass": (tiles["weights_bf16_exact"] and tiles["biases_bf16_exact"]
                             and tiles["max_rel_to_array_max"] <= tiles["rel_tol"])}
    return row, row["added_bit_identical"] and row["per_tile_pass"]


def per_tile_rows(per_tile, plain_tiles, style):
    """:func:`tile_rounding_gaps`'s rows of each tile, merged: every flag
    held on all tiles, every number its largest."""
    rows = [tile_rounding_gaps(k, p, style)[0] for k, p in zip(per_tile, plain_tiles)]
    out = {k: (all(r[k] for r in rows) if isinstance(v, bool) else max(r[k] for r in rows))
           for k, v in rows[0].items() if k != "worst_array"}
    out["worst_array"] = max(rows, key=lambda r: r["frac_over_ulps"])["worst_array"]
    return out


def reordered_tile_sums(fs, ft, plist, packed, tile, cfg, lw, nv, style, seed=2):
    """:func:`tile_sums` of the same function in another summation order:
    the units of every hidden layer permuted (each layer's output columns,
    the next layer's input rows), the gradients permuted back."""
    import torch

    H, Z = cfg.hidden_dim, cfg.latent_dim
    g = torch.Generator().manual_seed(seed)
    hid = {k: torch.randperm(H, generator=g) for k in
           ("cond_0", "cond_1", "enc_0", "enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2")}
    heads = torch.cat([hid["enc_3"], H + hid["cond_1"]])
    rows_in = {"cond_1": hid["cond_0"], "enc_1": hid["enc_0"], "enc_2": hid["enc_1"],
               "enc_3": hid["enc_2"], "fc_mu": heads, "fc_logvar": heads,
               "dec_0": torch.cat([torch.arange(Z), Z + hid["cond_1"]]),
               "dec_1": hid["dec_0"], "dec_2": hid["dec_1"], "dec_3": hid["dec_2"]}
    perm = [(rows_in.get(k, torch.arange(fi)).to(packed.device),
             hid.get(k, torch.arange(fo)).to(packed.device))
            for k, (fi, fo) in cfg.layer_spec().items()]
    moved = []
    for (r, c), w, b in zip(perm, plist[0::2], plist[1::2]):
        moved += [w[r][:, c], b[..., c]]
    back = []
    for sums in tile_sums(fs, moved, packed, tile, cfg, lw, nv, style):
        out = []
        for (r, c), w, b in zip(perm, sums[0::2], sums[1::2]):
            out += [w[torch.argsort(r)][:, torch.argsort(c)], b[..., torch.argsort(c)]]
        back.append(out)
    return back


def tiles_rounding_gaps(grads, plain, sums, style):
    """Several tiles' summed gradients against the plain version's under
    the autodiff backward in ``style``, the gap of each rounded array in
    units of the bf16 ulp of the largest of its tiles' sums (``sums``, from
    :func:`tile_sums`) → (row, whether at most TILE_ULPS on all but
    TILE_FRAC of the elements and every element within K4's 1e-2 rule).
    Printed beside :func:`tiles_added_gaps`, which holds the kernel."""
    import torch

    row = {"tiles": len(sums), "max_ulps": 0.0, "frac_over_ulps": 0.0,
           "max_rel_to_array_max": 0.0, "ulps_tol": TILE_ULPS, "frac_tol": TILE_FRAC,
           "rel_tol": K4_TOL["bfloat16"]["grad_rel_max"]}
    for i, (g, p) in enumerate(zip(grads, plain)):
        if not (i % 2 == 0 or style == "bf16_chain"):
            continue
        big = torch.stack([s[i].abs() for s in sums]).max(0).values
        unit = torch.where(big > 0, torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8),
                           torch.zeros_like(big))
        gap = (g - p).abs()
        ulps = torch.where(unit > 0, gap / unit.where(unit > 0, torch.ones_like(unit)),
                           torch.where(gap > 0, torch.full_like(gap, float("inf")),
                                       torch.zeros_like(gap)))
        row["max_ulps"] = max(row["max_ulps"], float(ulps.max()))
        row["frac_over_ulps"] = max(row["frac_over_ulps"],
                                    float((ulps > TILE_ULPS).float().mean()))
        row["max_rel_to_array_max"] = max(row["max_rel_to_array_max"], float(
            gap.max() / p.abs().max().clamp(min=1e-30)))
    ok = row["frac_over_ulps"] <= TILE_FRAC and row["max_rel_to_array_max"] <= row["rel_tol"]
    return row, ok


def tile_order_noise(fs, ft, scale_corpus, plist, cfg, lw, dev,
                     corpora=TILE_FRAC_CORPORA, orders=TILE_FRAC_ORDERS):
    """The one-tile check's rule applied to the plain version against
    itself with every hidden layer's units reordered (the same function,
    every product summed in another order): on a one-tile corpus of 352
    rows for each corpus seed in ``corpora`` (ε from seed + 1) and each
    permutation seed in ``orders``, under both bf16 styles → the largest
    share of an array's elements over TILE_ULPS, its row per case."""
    import numpy as np

    n1, worst, rows = 352, 0.0, []
    for c in corpora:
        eps = np.random.default_rng(c + 1).standard_normal((n1, cfg.latent_dim))
        nv, packed = fs._scale_inputs(scale_corpus(n1, seed=c), cfg, n1, "bfloat16",
                                      eps.astype(np.float32), dev)
        for style in ("f32_acts", "bf16_chain"):
            plain = tile_sums(fs, plist, packed, n1, cfg, lw, float(nv), style)[0]
            for o in orders:
                moved = reordered_tile_sums(fs, ft, plist, packed, n1, cfg, lw, float(nv),
                                            style, seed=o)[0]
                row, _ = tile_rounding_gaps(moved, plain, style)
                rows.append({"corpus": c, "style": style, "order": o,
                             "frac_over_ulps": row["frac_over_ulps"],
                             "max_ulps": row["max_ulps"]})
                worst = max(worst, row["frac_over_ulps"])
    return worst, rows


def tensor_core_ops(lib_path):
    """The HMMA and HGMMA instructions in a built library's SASS
    (``cuobjdump -sass``), counted over all its objects."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout.splitlines()
    return {op: sum(f" {op}." in ln or f" {op} " in ln for ln in sass)
            for op in ("HMMA", "HGMMA")}


def p1_wrong_sums(sa, ft, mode, packed, plist, cfg, lw, nv, w_in, w_ch, n_chain):
    """P1-sol's or P1-dx's sum from its plain version with one deliberate
    error each: {what is wrong: the sum}."""
    import dataclasses

    import torch

    if mode == "sol":
        h = packed.float() @ w_in.float()
        for _ in range(n_chain):
            h = h @ w_ch.float()
        return {"one_product_fewer": float(sa._sol_h(packed, w_in, w_ch, n_chain - 1).sum()),
                "no_bf16_rounding": float(h.sum())}
    x, cond, mask, eps = sa._split(packed, cfg)
    xv = x.float().requires_grad_(True)
    total, _ = ft._forward_loss(plist, xv, cond.float(), eps.float(), cfg, lw, mask,
                                n_valid=nv)
    out = {"float32_autodiff": float(torch.autograd.grad(total, xv)[0].sum())}
    for term in ("recon", "start"):
        gx = sa._dx_plain(packed, plist, cfg, dataclasses.replace(lw, **{term: 0.0}), nv)
        out[f"no_{term}_term"] = float(gx.float().sum())
    return out


def p2_wrong_sums(eps, grid, total):
    """P2's total from its plain version (``total``) with one deliberate
    error each, as a loop that stops a step early or a finish that misses a
    block's partial would give it: {what is wrong: the sum}, and each
    block's share of the stream in float64.  The layout is p2_kernel's for
    a 16-byte aligned stream: batch j of P2_BATCH elements goes to block
    j mod blocks."""
    import torch
    import torch.nn.functional as F

    flat = eps.reshape(-1).double()
    nb = -(-flat.numel() // P2_BATCH)
    batch = F.pad(flat, (0, nb * P2_BATCH - flat.numel())).view(nb, P2_BATCH).sum(1)
    blocks = min(nb, grid)
    shares = torch.zeros(blocks, dtype=torch.float64, device=eps.device).index_add_(
        0, torch.arange(nb, device=eps.device) % blocks, batch)
    median = int(shares.abs().argsort()[blocks // 2])
    return {"last_batch_dropped": total - float(batch[-1]),
            "median_block_dropped": total - float(shares[median])}, shares


def p1_sum_row(mode, kernel, plain, terms, wrong):
    """P1's compared sum (column 0, dx's column 5): kernel and plain beside
    its limit, and the wrong versions' gaps → (row, within the limit, every
    wrong version outside it)."""
    col = 5 if mode == "dx" else 0
    gap = float((kernel[:, col] - plain[:, col]).abs().max())
    tol = P1_TOL[mode] * terms
    ref = float(plain[0, col])
    row = {"kernel_sum": float(kernel[0, col]), "plain_sum": ref, "sum_gap": gap,
           "abs_terms": terms, "tol": tol, "tol_frac": P1_TOL[mode]}
    wrong_gaps = {k: abs(v - ref) for k, v in wrong.items()}
    if wrong_gaps:
        row["wrong_gaps"] = wrong_gaps
        row["wrong_gaps_frac"] = {k: v / terms for k, v in wrong_gaps.items()}
    return row, gap <= tol, all(v > tol for v in wrong_gaps.values())


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name, budget_s):
    """Run one phase under a watchdog; print its JSON line at the end."""
    faulthandler.dump_traceback_later(budget_s, exit=True)
    info = {}
    t0 = time.perf_counter()
    yield info
    faulthandler.cancel_dump_traceback_later()
    emit({"phase": name, "seconds": time.perf_counter() - t0, **info})


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=1):
    """(median milliseconds of ``fn()`` over ``reps`` runs by CUDA events,
    the last run's result)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], out


def device_ms(fn, count):
    """Milliseconds of each of ``count`` launches that ``fn()`` queues, on
    the device alone: the events' window opens behind a spin kernel, so the
    host has queued every launch before the device reaches it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def in_turns(kernel, library, rounds=TURN_ROUNDS):
    """Blocks of two timers (each returns ms) in turns, kernel, library,
    library, kernel, ``rounds`` times → ({"kernel": median, "library":
    median}, {"kernel": [min, max], "library": [min, max]})."""
    times = {"kernel": [], "library": []}
    for _ in range(rounds):
        for name in ("kernel", "library", "library", "kernel"):
            times[name].append((kernel if name == "kernel" else library)())
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return med, {k: [min(v), max(v)] for k, v in times.items()}


def host_us(fn, reps=P3_TIMING_REPS, blocks=5):
    """Median microseconds of one ``fn()`` over ``blocks`` blocks of
    ``reps`` calls, by the host clock (no device wait inside a block)."""
    import torch

    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def k3_gaps(kernel, plain, tol):
    """K3's (params, metrics) against its plain version's → the row of
    gaps beside ``tol``, and whether they are within it."""
    (pk, mk), (pp, mp) = kernel, plain
    p_abs = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    p_frac = max(float(((a - b).abs() > STEP_TENTH).float().mean()) for a, b in zip(pk, pp))
    m_rel = float(((mk[:, :5] - mp[:, :5]).abs() / mp[:, :5].abs().clamp(min=1e-6)).max())
    row = {"params_max_abs": p_abs, "params_tol": tol["params_abs"],
           "params_frac_over_step_tenth": p_frac, "params_frac_tol": tol["params_frac"],
           "metrics_max_rel": m_rel, "metrics_tol": tol["metrics_rel"]}
    ok = (p_abs <= tol["params_abs"] and p_frac <= tol["params_frac"]
          and m_rel <= tol["metrics_rel"])
    return row, ok


def knob_grad_gaps(knob, args, tol):
    """One epoch of K3 under ``knob`` with noadam beside it: the summed
    gradients its reduce writes to the sink, against the plain gradient
    pass under the same knob, as K4's are (``k4_gaps``)."""
    import torch

    from defensive_model_vae_tpu_torch.ops import fused_scale as fs
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft

    plist, packed, seed, cfg, lw, _, lr, tile, nv, cd, noise, eps_all = args
    bits = fs._check_ablate(("noadam", knob), cd)
    sink = torch.empty(ft.pack_kernel_params(plist).numel(), dtype=torch.float32,
                       device=packed.device)
    _, mk = fs._fused_scale_call_kernel(plist, packed, seed, cfg, lw, 1, lr, tile, nv, cd,
                                        noise, eps_all, bits, sink)
    src = fs._eps_source(noise, cfg, tile, packed.shape[0], None, seed, packed.device)
    gp, rp = fs._plain_grad_epoch(plist, packed, tile, cfg, lw, nv, cd, src, (knob,))
    return k4_gaps((ft.unpack_kernel_params(sink, plist), mk[:1]), (gp, rp), tol)


def k4_gaps(kernel, plain, tol):
    """K4's (gradients, (1, 8) row) against its plain version's (gradients,
    (5,) row) → the row of gaps beside ``tol``, and whether they are within
    it."""
    (gk, rk), (gp, rp) = kernel, plain
    g_rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(gk, gp))
    g_abs = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    r_rel = float(((rk[0, :5] - rp).abs() / rp.abs().clamp(min=1e-6)).max())
    row = {"grad_max_rel_to_array_max": g_rel, "grad_tol": tol["grad_rel_max"],
           "grad_max_abs": g_abs, "row_max_rel": r_rel, "row_tol": tol["row_rel"]}
    return row, g_rel <= tol["grad_rel_max"] and r_rel <= tol["row_rel"]


def grid_gaps(kernel, plain, tol):
    """A grid's (stacked params, (S, E, 8) metrics) against its plain
    version's → the row of gaps beside ``tol`` (GRID_TOL's), and whether
    they are within it.  Each metrics gap is reported relative to its
    component and to its row's total; ``tol["metrics_vs"]`` says which is
    held to ``tol["metrics_rel"]``."""
    (pk, mk), (pp, mp) = kernel, plain
    p_abs = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    d = (mk[..., :5] - mp[..., :5]).abs()
    m_rel = float((d / mp[..., :5].abs().clamp(min=1e-6)).max())
    m_rel_total = float((d / mp[..., :1].abs().clamp(min=1e-6)).max())
    held = m_rel if tol["metrics_vs"] == "component" else m_rel_total
    row = {"params_max_abs": p_abs, "params_tol": tol["params_abs"],
           "metrics_max_rel": m_rel, "metrics_max_rel_to_total": m_rel_total,
           "metrics_tol": tol["metrics_rel"], "metrics_held_vs": tol["metrics_vs"]}
    return row, p_abs <= tol["params_abs"] and held <= tol["metrics_rel"]


def one_ulp(stacked, seed=1):
    """The stacked params times (1 + 2⁻²³·n), n ~ N(0, 1): one float32 ulp
    of noise, to measure how far the plain version alone drifts from it."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(a * (1 + 2.0 ** -23 * torch.randn(a.shape, generator=g).to(a.device))
                 for a in stacked)


def check_tracked(traces, mpc, what):
    """Finite tracked states whose controls, read off the states, are within
    the bounds: |Δv| ≤ a_max·dt and |Δθ| ≤ |v|·tan(δ_max)/L·dt.  → steps."""
    import numpy as np

    steps = 0
    for tr in traces:
        if not np.all(np.isfinite(tr)):
            fail(f"non-finite tracked states ({what})")
        dv = np.abs(np.diff(tr[:, 3]))
        dth = np.abs(np.diff(tr[:, 2]))
        lim = np.abs(tr[:-1, 3]) * np.tan(mpc.max_steer) / mpc.wheelbase * mpc.dt
        if dv.max() > mpc.max_accel * mpc.dt * (1 + 1e-4) or np.any(dth > lim * (1 + 1e-4) + 1e-6):
            fail(f"tracked states imply controls outside the bounds ({what})")
        steps += len(tr) - 1
    return steps


def converged(hist_by, what):
    """Every run's loss finite and its last epoch below a fifth of its first
    (bench.py:704-712) → {run: [first, last]}."""
    import numpy as np

    out = {}
    for k, h in hist_by.items():
        first, last = float(h["total"][0]), float(h["total"][-1])
        if not (np.all(np.isfinite(np.stack(list(h.values())))) and last < first / 5):
            fail(f"{what}: run {k} did not converge: loss {first} -> {last}")
        out[str(k)] = [first, last]
    return out


def window_epoch_flops(cfg):
    """The products of one window in one epoch: the forward, the weight
    gradients and the activation gradients (none for the inputs of cond_0
    and enc_0), two FLOP a multiply-add."""
    spec = cfg.layer_spec()
    mac = sum(fi * fo for fi, fo in spec.values())
    mac_da = mac - sum(spec[n][0] * spec[n][1] for n in ("cond_0", "enc_0"))
    return 2 * (2 * mac + mac_da)


def k1_flops_bytes(cfg, B, epochs):
    """K1's work from this run's shapes: the products and Adam's ~10
    operations per parameter an epoch; the bytes of x, cond, eps, the
    params in and out and the metrics."""
    n_params = cfg.n_params()
    flops = epochs * (B * window_epoch_flops(cfg) + 10 * n_params)
    nbytes = 4 * (B * (cfg.seq_len * cfg.dim + cfg.cond_dim + cfg.latent_dim)
                  + 2 * n_params + 8 * epochs)
    return flops, nbytes


def grid_flops_bytes(cfg, rows, input_rows, epochs):
    """A grid of whole runs (K2, the seed grid) from this run's shapes: each
    run's products on its ``rows[s]`` rows and its Adam; the bytes of the
    ``input_rows`` rows of x and cond read once, each run's params in and
    out and its metrics (Philox noise reads nothing)."""
    n_params = cfg.n_params()
    flops = epochs * sum(b * window_epoch_flops(cfg) + 10 * n_params for b in rows)
    nbytes = 4 * (input_rows * (cfg.seq_len * cfg.dim + cfg.cond_dim)
                  + len(rows) * (2 * n_params + 8 * epochs))
    return flops, nbytes


def scale_flops_bytes(cfg, n, epochs, adam, itemsize, width, eps_stream=True):
    """K3's (adam) or K4's work from this run's shapes: the products (and
    Adam's ~10 operations per parameter an epoch); the bytes of the corpus
    and the ε stream (none when the kernel draws it, ``eps_stream=False``),
    each read once, and the params (in and out) or gradients and the
    metrics.  The autodiff instances do the same products."""
    n_params = cfg.n_params()
    flops = epochs * (n * window_epoch_flops(cfg) + (10 * n_params if adam else 0))
    nbytes = (itemsize * n * (width + (epochs * cfg.latent_dim if eps_stream else 0))
              + 4 * (2 * n_params + 8 * epochs))
    return flops, nbytes


def p1_flops(cfg):
    """P1's products a window-epoch: sol (the entry product and the chain),
    fwd (the forward, 2·Σ in·out) and dx (the forward and the chain back to
    x: dec_3..dec_1, dec_0's dz columns, the μ and logσ² heads, enc_3..enc_0)."""
    spec = cfg.layer_spec()
    width = cfg.seq_len * cfg.dim + cfg.cond_dim + 1 + cfg.latent_dim
    H, Z = cfg.hidden_dim, cfg.latent_dim
    n_chain = round((6 * sum(fi * fo for fi, fo in spec.values()) - 2 * width * 128)
                    / (2 * 128 * 128))
    fwd = 2 * sum(fi * fo for fi, fo in spec.values())
    chain = (sum(spec[n][0] * spec[n][1] for n in ("dec_3", "dec_2", "dec_1", "enc_3",
                                                   "enc_2", "enc_1", "enc_0"))
             + Z * H + 2 * H * Z)
    return {"sol": 2 * width * 128 + n_chain * 2 * 128 * 128, "fwd": fwd,
            "dx": fwd + 2 * chain}


def bound(flops, nbytes, peak):
    """(bound ms, what bounds it) for work of ``flops`` at ``peak`` FLOP/s
    moving ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _http(port, path, payload=None, raw=False):
    """(seconds, status, body) of one request to the local server."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        status = r.status
    return time.perf_counter() - t0, status, body if raw else json.loads(body)


def device_busy_ms(torch, fn):
    """(milliseconds of the device work that ``fn()`` ran, its count of
    device events) by ``torch.profiler``, read from the raw trace (building
    the profiler's event tree costs ~0.5 s for a few thousand kernels).
    Fails where the profiler records no device time: the phase's host
    share needs it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    if not ns:
        fail("torch.profiler recorded no device time for the serve program")
    return sum(ns) / 1e6, len(ns)


def serve_phase(np, torch, dev, w4, card):
    """The serving path at the deployment's size: the four committed
    checkpoints (CVAEConfig(), nothing cut) behind one endpoint, batch 16,
    512 steps.  One /serve to sce4 with 16 sce4 starts, the first row alone
    bit for bit the batch's row 0, the answer equal to what the serve
    program returned inside the request, each row's device reference held
    against the host PathReference and its states against the same
    waypoints tracked through the host reference, row 0's against its own
    waypoints (every row's error printed: the request's fixture speeds run
    ahead of some sampled paths, in JAX's program too), one /generate to
    sce1 as npz.  Times: each request's wall time; the serve program's
    inside the first request by CUDA events; its device kernels' time by
    torch.profiler over 4 and 8 steps of the same program, extrapolated
    to 512 (every step runs the same kernels), and so the host share."""
    import io
    import threading

    from defensive_model_vae_tpu_torch import serving
    from defensive_model_vae_tpu_torch.control import MPCConfig, PathReference
    from defensive_model_vae_tpu_torch.control import device_reference as dr
    from defensive_model_vae_tpu_torch.control.mpc import _initial_tracker_state, _simulate
    from defensive_model_vae_tpu_torch.models import sample
    from defensive_model_vae_tpu_torch.pipeline import fixture_starts
    from defensive_model_vae_tpu_torch.train import load_checkpoint

    info = {"card": card}
    ckpts = {k: os.path.join(HERE, "results", "checkpoints", k)
             for k in ("sce1", "sce2", "sce3", "sce4")}
    t0 = time.perf_counter()
    server = serving.serve_checkpoint(ckpts, SERVE_BATCH, SERVE_STEPS, dt=SERVE_DT,
                                      port=0, warm_seed=1, device=dev)
    info["load_and_warm_s"] = time.perf_counter() - t0
    # the sce4 program, timed by CUDA events inside the request, its
    # outputs kept for the comparison with the answer
    program, seen = server.serve_fns["sce4"], []

    def timed_program(seed, starts, inits):
        ms, out = cuda_ms(lambda: program(seed, starts, inits))
        seen.append((ms, [o.cpu().numpy() for o in out]))
        return out

    server.serve_fns["sce4"] = timed_program
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        port = server.server_address[1]
        _, code, health = _http(port, "/healthz")
        if code != 200 or health["models"] != sorted(ckpts) or \
                (health["batch"], health["steps"]) != (SERVE_BATCH, SERVE_STEPS):
            fail(f"/healthz: {code} {health}")
        starts, inits = fixture_starts(w4[:SERVE_BATCH])
        rows = [{"start_x": float(a[0]), "start_y": float(a[1]), "heading": float(b[2]),
                 "vx": float(b[3]), "vy": float(b[4])} for a, b in zip(starts, inits)]
        req = {"requests": rows, "seed": SERVE_SEED, "model": "sce4"}
        wall, code, body = _http(port, "/serve", req)
        bad = set(body.get("invalid", []))
        if code != 200 or body["n"] != SERVE_BATCH:
            fail(f"/serve: {code} n={body.get('n')}")
        ev_ms, (d_states, _) = seen[0]
        for b, st in enumerate(body["states"]):
            if st is None and b not in bad or st is not None and \
                    not np.all(np.isfinite(np.asarray(st))):
                fail(f"/serve row {b}: neither finite nor listed in 'invalid'")
            if st is not None and not np.array_equal(np.asarray(st, np.float32), d_states[b]):
                fail(f"/serve row {b} differs from what the serve program returned")
        wall1, _, one = _http(port, "/serve", {**req, "requests": rows[:1]})
        if one["states"][0] != body["states"][0]:
            fail("the first request alone is not row 0 of the batch bit for bit")
        info.update(serve_wall_s=wall, serve_one_row_wall_s=wall1,
                    serve_fn_cuda_event_ms=ev_ms, ms_per_step=ev_ms / SERVE_STEPS)

        # the device's share: the same program at 4 and 8 steps, profiled
        p4, c4, m4 = load_checkpoint(ckpts["sce4"], dev)
        P, M = serving.SERVE_HORIZONS
        mpc = MPCConfig(prediction_horizon=P, control_horizon=M, dt=SERVE_DT)
        pstarts, pinits, _ = serving._parse_requests(rows, SERVE_BATCH)
        prof, prof_s = {}, []
        for steps in SERVE_PROFILE_STEPS:
            short = dr.make_serve_fn(p4, c4, mpc, steps, m4.get("offset_mode", True))
            t0 = time.perf_counter()
            prof[steps] = device_busy_ms(torch, lambda: short(SERVE_SEED, pstarts, pinits))
            prof_s.append(time.perf_counter() - t0)
        # the first session's seconds hold the profiler's start-up
        info["profile_s"] = prof_s
        lo, hi = SERVE_PROFILE_STEPS
        per_step = (prof[hi][0] - prof[lo][0]) / (hi - lo)
        busy = prof[hi][0] + per_step * (SERVE_STEPS - hi)
        info.update(device_busy_ms_extrapolated=busy, device_busy_ms_per_step=per_step,
                    kernels_per_step=(prof[hi][1] - prof[lo][1]) / (hi - lo),
                    profiled_steps=list(SERVE_PROFILE_STEPS),
                    profiled_busy_ms=[prof[lo][0], prof[hi][0]],
                    profiled_kernels=[prof[lo][1], prof[hi][1]],
                    host_share=1.0 - busy / ev_ms)

        # each row's reference and tracking against the host, from its draws
        t0 = time.perf_counter()
        z = dr.request_draws(SERVE_SEED, SERVE_BATCH, dr._N_DRAWS, c4.latent_dim, dev)
        st_t, in_t = torch.as_tensor(pstarts).to(dev), torch.as_tensor(pinits).to(dev)
        with torch.no_grad():
            cands = sample(p4, None, st_t.repeat_interleave(dr._N_DRAWS, dim=0), c4,
                           z=z.reshape(-1, c4.latent_dim))
            traj = dr.select_valid_trajectory(cands.reshape(SERVE_BATCH, dr._N_DRAWS,
                                                            c4.seq_len, c4.dim))
            wp = torch.stack([traj[..., 1], traj[..., 2], traj[..., 0]], dim=-1)
            refs = dr.build_reference_device(wp, in_t, SERVE_STEPS, P, SERVE_DT).cpu().numpy()
        wp = wp.cpu().numpy().astype(float)
        live = [b for b in range(SERVE_BATCH) if b not in bad]
        worst = {"theta": 0.0, "v": 0.0}
        host_refs, pos_mean = [], {}
        for b in live:
            ref = PathReference(wp[b], pinits[b].astype(float))
            host = ref.build(SERVE_STEPS, P, SERVE_DT)
            host_refs.append(host)
            gap = np.abs(host - refs[b]).reshape(-1, 2).max(axis=0)
            worst = {"theta": max(worst["theta"], float(gap[0])),
                     "v": max(worst["v"], float(gap[1]))}
            n = min(SERVE_STEPS + 1, int(wp[b, -1, 2] / SERVE_DT) + 1)
            pos_mean[b] = float(ref.position_error(np.arange(n) * SERVE_DT,
                                                   d_states[b, :n, :2]).mean())
        # the same waypoints tracked through the host reference (the
        # track_batch path) on the host: the served states within the
        # tracker's whole-simulation tolerance (tests/test_torch_mpc.py)
        s0 = np.stack([_initial_tracker_state(pinits[b]) for b in live])
        hs, _ = _simulate(mpc, torch.as_tensor(s0, dtype=torch.float32),
                          torch.as_tensor(np.stack(host_refs), dtype=torch.float32),
                          torch.zeros((len(live), 2)))
        host_gap = float(np.abs(hs.numpy() - d_states[live]).max())
        info.update(n_invalid=len(bad), worst=worst, host_track_max_abs=host_gap,
                    pos_mean_m=pos_mean, host_checks_s=time.perf_counter() - t0)
        if worst["theta"] >= SERVE_THETA_TOL or worst["v"] >= SERVE_V_TOL:
            fail(f"device reference against the host PathReference: {worst}")
        if host_gap >= SERVE_HOST_TRACK_TOL:
            fail(f"served states against the host reference's tracking: {host_gap}")
        # request 0 tracks its own waypoints, as tests/test_mpc.py:290 holds it
        if 0 in bad or pos_mean[0] >= SERVE_POS_MEAN_M:
            fail(f"served row 0 does not track its waypoints: {pos_mean.get(0)}")

        # /generate to sce1, npz
        s1, _ = fixture_starts(np.load(os.path.join(HERE, "fixtures",
                                                    "trajectory_sce1_cond.npy"))[:SERVE_BATCH])
        gwall, code, raw = _http(port, "/generate", {
            "requests": [{"start_x": float(a[0]), "start_y": float(a[1])} for a in s1],
            "seed": SERVE_SEED, "model": "sce1", "format": "npz"}, raw=True)
        gz = np.load(io.BytesIO(raw))
        tr = gz["trajectories"]
        if code != 200 or tr.shape != (len(s1), 10, 3) or str(gz["model"]) != "sce1":
            fail(f"/generate: {code} {tr.shape}")
        fin = np.isfinite(tr.reshape(len(s1), -1)).all(axis=1)
        if sorted(np.flatnonzero(~fin).tolist()) != sorted(gz["invalid"].tolist()):
            fail("/generate: non-finite rows not listed in 'invalid'")
        _, _, health = _http(port, "/healthz")
        info.update(generate_wall_s=gwall, served=health["served"],
                    rejected=health["rejected"], errors=health["errors"],
                    last_ms=health["last_ms"])
        if health["served"] != 3 or health["errors"] or health["rejected"]:
            fail(f"/healthz counters: {health}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from defensive_model_vae_tpu_torch import cli, scenarios
    from defensive_model_vae_tpu_torch._device import resolve_device
    from defensive_model_vae_tpu_torch.control import MPCConfig, track_batch
    from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
    from defensive_model_vae_tpu_torch.ops import _build
    from defensive_model_vae_tpu_torch.ops import cache_decoy as cdy
    from defensive_model_vae_tpu_torch.ops import fused_scale as fs
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.ops import scale_ablation as sa
    from defensive_model_vae_tpu_torch.scripts import cache_probe
    from defensive_model_vae_tpu_torch.scripts import noise_consumer_probe as ncp
    from defensive_model_vae_tpu_torch.scripts import k1_digest as k1d
    from defensive_model_vae_tpu_torch.scripts import k1_phases as k1p
    from defensive_model_vae_tpu_torch.scripts import k3_digest as k3d
    from defensive_model_vae_tpu_torch.scripts import scale_ablation as sab
    from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus
    from defensive_model_vae_tpu_torch.pipeline import (
        _draw_valid_samples, default_mpc_cfg, fixture_starts,
        generate_and_track_from_starts, generate_and_track_multi_from_starts)
    from defensive_model_vae_tpu_torch.train import (TrainConfig, load_checkpoint,
                                                     save_checkpoint, train,
                                                     train_conditioned,
                                                     train_multi_scenario)

    dev = resolve_device("cuda")
    cfg, lw = CVAEConfig(), LossWeights()

    # ---- 1. device --------------------------------------------------------
    with phase("device", 60) as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                timeout=30).stdout.strip().splitlines()
        try:
            import triton  # noqa: F401

            has_triton = True
        except ImportError:
            has_triton = False
        info.update(torch=torch.__version__, cuda=torch.version.cuda,
                    name=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count(),
                    nvcc=nvcc_v[-1] if nvcc_v else None, triton=has_triton)
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    card = smi[0] if smi else "unknown"

    # ---- 2. build, beside the cache probe's rounds of nvcc ---------------
    # The probe's rounds A and A2 start first; P3 is then built, launched and
    # held against its plain version (the decoy); round B starts; then every
    # kernel of the port builds, all side by side on the host's cores.
    probe = cache_probe.Probe(timeout=CACHE_PROBE_ROUND_S)
    atexit.register(probe.close)  # a failed phase leaves no nvcc running
    with phase("build", 240) as info:
        probe.start("A")
        probe.start("A2")
        cdy.decoy.launches = 0
        p3_check = probe.decoy(dev)
        p3_launches = cdy.decoy.launches
        probe.start("B")
        built = _build.build_all()
        for name, b in built.items():
            ptxas = [ln.strip() for ln in b["log"].splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln]
            info[name] = {"seconds": b["seconds"], "cached": b["cached"], "ptxas": ptxas}
            _build.load(name)
        # K3's and K4's bf16 weight gradients on the tensor cores: their
        # library's SASS holds mma instructions (HMMA; HGMMA for wgmma);
        # P1's products, all on FMA, are counted beside it
        sass_mma = {name: tensor_core_ops(_build._lib_path(name))
                    for name in ("fused_scale", "scale_ablation")}
        info["sass_mma"] = sass_mma
        if not sass_mma["fused_scale"]["HMMA"] + sass_mma["fused_scale"]["HGMMA"]:
            fail(f"K3/K4's library holds no tensor-core instruction: {sass_mma}")

    # ---- 3. cache_probe: the rounds' verdicts, and P3 timed ---------------
    with phase("cache_probe", 90) as info:
        cp = probe.finish()
        emit({"cache_probe": cp})
        if p3_launches != 1 or not p3_check["exact"]:
            fail(f"P3 launched {p3_launches} times (expected 1) or is not x * 2 + 1 "
                 f"bit for bit: {p3_check}")
        if not all(r["determinism"] and r["context"] for r in cp["specs"].values()):
            fail("the cache probe printed no verdict for some object")
        xp = torch.randn(cdy.SHAPE, generator=torch.Generator().manual_seed(1)).to(dev)
        ones = torch.ones_like(xp)
        want = cdy._decoy_plain(xp.cpu())

        def p3_call():
            return cdy.decoy(xp)

        def lib_call():
            return torch.add(ones, xp, alpha=2.0)

        def per_call(fn):
            return cuda_ms(lambda: [fn() for _ in range(P3_TIMING_REPS)])[0] / P3_TIMING_REPS

        # through the wrapper: what a caller sees, host work and launch
        for warm in (p3_call, lib_call, lambda: cdy._decoy_plain(xp)):
            per_call(warm)
        p3_med, p3_spread = in_turns(lambda: per_call(p3_call), lambda: per_call(lib_call))
        p3_plain_ms = per_call(lambda: cdy._decoy_plain(xp))
        # on the device alone: P3_GRAPH_CALLS calls captured in one graph
        # each; P3's capture fails unless it launches on torch's current
        # stream (the capture stream), and every replayed output is checked
        graphs, outs = {}, {}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        for name, fn in (("kernel", p3_call), ("library", lib_call)):
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graphs[name] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[name]):
                outs[name] = [fn() for _ in range(P3_GRAPH_CALLS)]
        p3_dev_med, p3_dev_spread = in_turns(
            lambda: device_ms(graphs["kernel"].replay, P3_GRAPH_CALLS),
            lambda: device_ms(graphs["library"].replay, P3_GRAPH_CALLS))
        want_dev = want.to(dev)
        p3_graph_exact = all(torch.equal(o, want_dev) for o in outs["kernel"])
        if not p3_graph_exact:
            fail("P3 replayed from a CUDA graph is not x * 2 + 1 bit for bit")
        del graphs, outs
        # the host split of one call: each part alone, host clock
        out = torch.empty_like(xp)
        idx, n, optr, xptr = dev.index or 0, xp.numel(), out.data_ptr(), xp.data_ptr()
        raw = cdy._raw_stream(idx)
        p3_ctypes = _build.load("cache_decoy").p3_decoy  # the same launch through ctypes
        f32 = torch.float32
        p3_split_us = {
            "loop": host_us(lambda: None),
            "checks": host_us(lambda: xp.dtype is not f32 or not xp.is_cuda
                              or not xp.is_contiguous()),
            "alloc": host_us(lambda: torch.empty_like(xp)),
            "args": host_us(lambda: (xp.data_ptr(), out.data_ptr(), xp.numel(),
                                     xp.get_device())),
            "stream_raw": host_us(lambda: cdy._raw_stream(idx)),
            "stream_current_dev": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
            "stream_current": host_us(lambda: torch.cuda.current_stream().cuda_stream),
            "launch": host_us(lambda: cdy._launch(xptr, optr, n, raw)),
            "ctypes_launch": host_us(lambda: p3_ctypes(xptr, optr, n, raw)),
            "call": host_us(p3_call),
            "library_call": host_us(lib_call),
        }

        def ctypes_call():  # the wrapper as it is, its launch through ctypes
            if xp.dtype is not f32 or not xp.is_cuda or not xp.is_contiguous():
                raise ValueError("unreachable")
            o = torch.empty_like(xp)
            p3_ctypes(xp.data_ptr(), o.data_ptr(), xp.numel(), cdy._raw_stream(xp.get_device()))
            return o

        # the whole call through ctypes in turns with torch.add (host clock)
        med, spread = in_turns(lambda: host_us(ctypes_call, blocks=1),
                               lambda: host_us(lib_call, blocks=1))
        p3_split_us["ctypes_call_in_turns"] = {"ctypes_call": med["kernel"],
                                               "library_call": med["library"],
                                               "spread": {"ctypes_call": spread["kernel"],
                                                          "library_call": spread["library"]}}
        p3_ms, p3_lib_ms = p3_med["kernel"], p3_med["library"]
        p3_timing = {"ms": p3_ms, "device_ms": p3_dev_med["kernel"], "library_ms": p3_lib_ms,
                     "library_device_ms": p3_dev_med["library"],
                     "spread": {"ms": p3_spread["kernel"], "device_ms": p3_dev_spread["kernel"],
                                "library_ms": p3_spread["library"],
                                "library_device_ms": p3_dev_spread["library"]},
                     "host_split_us": p3_split_us}
        info.update(p3_launches=p3_launches, p3_exact=p3_check["exact"],
                    p3_graph_exact=p3_graph_exact,
                    round_s=cp["round_s"], probe_s=cp["seconds"], all_stable=cp["all_stable"],
                    nvcc=cp["nvcc"], p3=p3_timing, p3_plain_ms=p3_plain_ms, card=card)

    # ---- 4. K1 against its plain version ----------------------------------
    k1_err = {}
    with phase("k1_vs_plain", 150) as info:
        rows = []
        for sce in ("sce2", "sce4"):
            w = np.load(scenarios.get(sce).fixture_windows)
            x, c = ft.fused_inputs(w, dev)
            plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
            eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
                (len(w), cfg.latent_dim)).astype(np.float32)).to(dev)
            for epochs in (1, 50):
                pk, mk = ft.fused_call(plist, x, c, 0, cfg, lw, epochs, 1e-3, eps)
                pp, mp = ft._fused_call_plain(plist, x, c, 0, cfg, lw, epochs, 1e-3, eps)
                torch.cuda.synchronize()
                p_abs = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
                m_rel = float(((mk[:, :5] - mp[:, :5]).abs()
                               / mp[:, :5].abs().clamp(min=1e-6)).max())
                tol = K1_TOL[epochs]
                row = {"scenario": sce, "B": len(w), "epochs": epochs,
                       "params_max_abs": p_abs, "params_tol": tol["params_abs"],
                       "metrics_max_rel": m_rel, "metrics_tol": tol["metrics_rel"]}
                rows.append(row)
                emit({"k1_vs_plain": row})
                if not (p_abs <= tol["params_abs"] and m_rel <= tol["metrics_rel"]):
                    fail(f"K1 disagrees with its plain version: {row}")
                if sce == "sce4" and epochs == 50:
                    k1_err["max_abs_err"] = p_abs
        info["cases"] = len(rows)

    # ---- 5. train: the main path ------------------------------------------
    w4 = np.load(scenarios.get("sce4").fixture_windows)
    epochs = 3000
    with phase("train", 360) as info:
        ft.fused_call.launches = 0
        t0 = time.perf_counter()
        # K1's time: CUDA events around the main path's one launch (and the
        # trainer's input preparation, milliseconds)
        kernel_ms, (params, hist) = cuda_ms(lambda: ft.fused_train(
            w4, epochs=epochs, lr=1e-3, weights=lw, seed=0, device=dev))
        wall = time.perf_counter() - t0
        launches, k1_cluster = ft.fused_call.launches, ft.fused_call.cluster
        if launches != 1:
            fail(f"fused_train launched K1 {launches} times, expected 1")
        tot = hist["total"]
        if not np.all(np.isfinite(np.stack(list(hist.values())))):
            fail("non-finite training metrics")
        if not tot[-1] < tot[0]:
            fail(f"loss did not descend: {tot[0]} -> {tot[-1]}")
        # the plain version's time on the same inputs
        x, c = ft.fused_inputs(w4, dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        plain_part_ms, _ = cuda_ms(lambda: ft._fused_call_plain(
            plist, x, c, 0, cfg, lw, PLAIN_K1_EPOCHS, 1e-3, None))
        plain_ms = plain_part_ms * epochs / PLAIN_K1_EPOCHS
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, params, cfg, "sce4", hist)
            loaded, cfg2, _ = load_checkpoint(d, dev)
            same = all(torch.equal(loaded[k][n], params[k][n])
                       for k in params for n in ("w", "b"))
        if not same or cfg2 != cfg:
            fail("checkpoint round trip changed the params")
        # K1's phase split: one more run with the timer (off the main path)
        k1_split = k1p.split(dev, "k1", SPLIT_EPOCHS)
        info.update(epochs=epochs, B=len(w4), launches=launches, main_path_s=wall,
                    cluster=k1_cluster, loss_first=float(tot[0]), loss_last=float(tot[-1]),
                    kernel_ms=kernel_ms, plain_ms=plain_ms,
                    plain_epochs_timed=PLAIN_K1_EPOCHS, timed_ms=k1_split[0],
                    split_epochs=SPLIT_EPOCHS,
                    phases_ms=k1_split[1], card=card)

    # ---- 6. sample ----------------------------------------------------------
    starts, inits = fixture_starts(w4)
    with phase("sample", 60) as info:
        gen, ok = _draw_valid_samples(params, cfg, starts, seed=0)
        if not np.all(np.isfinite(gen)):
            fail("non-finite samples")
        info.update(n_starts=len(starts), n_valid=int(ok.sum()))
        if not ok.any():
            fail("no valid sample")

    # ---- 7. track -----------------------------------------------------------
    with phase("track", 240) as info:
        mpc = default_mpc_cfg(scenarios.get("sce4"))
        t0 = time.perf_counter()
        traces, idx = generate_and_track_from_starts(params, cfg, starts, inits,
                                                     seed=0, mpc_cfg=mpc)
        info["generate_and_track_s"] = time.perf_counter() - t0
        if len(traces) != int(ok.sum()):
            fail("tracked fewer paths than valid samples")
        steps = check_tracked(traces, mpc, "sce4")
        info.update(n_tracked=len(traces), tracked_steps=steps)

        # the SLSQP golden windows (tests/test_mpc.py:124-148)
        w1 = np.load(scenarios.get("sce1").fixture_windows)
        with open(os.path.join(HERE, "fixtures", "oracle", "sce1_start.json")) as f:
            sc = json.load(f)
        ocfg = MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02)
        wps, ins = [], []
        for i in (1, 3):
            wp = w1[i][:, [1, 2, 0]].astype(float)
            wp[0, 2] = 0.0
            wps.append(wp)
            ins.append([wp[0, 0], wp[0, 1], sc["angle"], sc["vx"], sc["vy"]])
        t0 = time.perf_counter()
        _, st, ctl, nsteps = track_batch(np.stack(wps), np.asarray(ins), ocfg, device=dev)
        info["oracle_track_s"] = time.perf_counter() - t0
        if np.abs(ctl[:, :, 0]).max() > ocfg.max_accel + 1e-5 or \
                np.abs(ctl[:, :, 1]).max() > ocfg.max_steer + 1e-5:
            fail("controls outside the bounds")
        for b, i in enumerate((1, 3)):
            ref = np.load(os.path.join(HERE, "fixtures", "oracle", f"ref_track_sce1w{i}.npy"))
            s = st[b, : int(nsteps[b]) + 1]
            n = min(len(s), len(ref))
            pos = np.hypot(s[:n, 0] - ref[:n, 0], s[:n, 1] - ref[:n, 1])
            dv = np.abs(s[:n, 3] - ref[:n, 3])
            band = {"window": i, "pos_max": float(pos.max()), "pos_mean": float(pos.mean()),
                    "dv_mean": float(dv.mean())}
            info[f"oracle_w{i}"] = band
            if not (pos.max() < 1.0 and pos.mean() < 0.4 and dv.mean() < 0.2):
                fail(f"tracking outside the SLSQP-oracle bands: {band}")


    # ---- 8. K3 and K4 against their plain versions ------------------------
    # a block takes ceil(steps / SMs) 32-row steps: one in the 4096- and
    # 1000-row cases, five (and a short last chunk) in the 20,000-row one,
    # 32 at the bench shape (phase 8)
    with phase("k3_vs_plain", 90) as info:
        rows = []
        for n, tile, cd, noise, epoch_list in ((4096, 512, None, "packed", (1, 20)),
                                               (4096, 512, "bfloat16", "hbm", (1, 20)),
                                               (1000, 256, None, "prng", (5,)),
                                               (20000, 256, None, "prng", (1, 5))):
            w = scale_corpus(n)
            eps = (np.random.default_rng(1).standard_normal((n, cfg.latent_dim))
                   .astype(np.float32) if noise == "packed" else None)
            nv, packed = fs._scale_inputs(w, cfg, tile, cd, eps, dev)
            plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
            for ep in epoch_list:
                eps_all = (fs.hbm_noise(3, ep, packed.shape[0], cfg.latent_dim, cd, dev)
                           if noise == "hbm" else None)
                args = (plist, packed, 3, cfg, lw, ep, 1e-3, tile, float(nv), cd, noise,
                        eps_all)
                gaps, ok = k3_gaps(fs._fused_scale_call(*args),
                                   fs._fused_scale_call_plain(*args), K3_TOL[(cd, ep)])
                row = {"kernel": "K3", "n": n, "tile": tile, "dtype": cd or "float32",
                       "noise": noise, "epochs": ep, **gaps}
                rows.append(row)
                emit({"k3_vs_plain": row})
                if not ok:
                    fail(f"K3 disagrees with its plain version: {row}")
            if noise == "packed":
                continue
            # K4: one epoch's summed gradients and loss row
            e0 = None if noise == "prng" else fs.hbm_noise(3, 1, packed.shape[0],
                                                          cfg.latent_dim, cd, dev)
            src = fs._eps_source(noise, cfg, tile, packed.shape[0], e0, 11, dev)
            gaps, ok = k4_gaps(
                fs._grad_epoch_call(plist, packed, 11, cfg, lw, tile, float(nv), cd,
                                    noise, e0),
                fs._plain_grad_epoch(plist, packed, tile, cfg, lw, float(nv), cd, src),
                K4_TOL[cd])
            row = {"kernel": "K4", "n": n, "tile": tile, "dtype": cd or "float32",
                   "noise": noise, **gaps}
            rows.append(row)
            emit({"k3_vs_plain": row})
            if not ok:
                fail(f"K4 disagrees with its plain version: {row}")
        info["cases"] = len(rows)

    # ---- 9. train_scale: the production-scale path at the bench shape -----
    ws = scale_corpus(SCALE_N)
    with phase("train_scale", 120) as info:
        fs._fused_scale_call.launches = 0
        fs._grad_epoch_call.launches = 0
        t0 = time.perf_counter()
        sparams, shist = fs.fused_train_scale(ws, epochs=SCALE_EPOCHS, tile=SCALE_TILE,
                                              compute_dtype="bfloat16", noise="hbm",
                                              seed=0, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k3_launches = fs._fused_scale_call.launches
        if k3_launches != 1:
            fail(f"fused_train_scale launched K3 {k3_launches} times, expected 1")
        tot = shist["total"]
        if not np.all(np.isfinite(np.stack(list(shist.values())))):
            fail("non-finite production-scale training metrics")
        if not tot[-1] < tot[0]:
            fail(f"production-scale loss did not descend: {tot[0]} -> {tot[-1]}")
        # times on the same inputs: K3 (one run), its plain version
        nv, packed = fs._scale_inputs(ws, cfg, SCALE_TILE, "bfloat16", None, dev)
        n_pad = packed.shape[0]
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        eps_all = fs.hbm_noise(0, SCALE_EPOCHS, n_pad, cfg.latent_dim, "bfloat16", dev)
        args = (plist, packed, 0, cfg, lw, SCALE_EPOCHS, 1e-3, SCALE_TILE, float(nv),
                "bfloat16", "hbm", eps_all)
        k3_ms, _ = cuda_ms(lambda: fs._fused_scale_call(*args))
        # the first PROBE_EPOCHS epochs of the same run: K3 against its plain
        # version at the shape the main path gives it (32 steps a block)
        probe = (*args[:5], PROBE_EPOCHS, *args[6:11], eps_all[:PROBE_EPOCHS * n_pad])
        probe_ms, probe_plain = cuda_ms(lambda: fs._fused_scale_call_plain(*probe))
        k3_bench, ok = k3_gaps(fs._fused_scale_call(*probe), probe_plain,
                               K3_TOL[("bfloat16", PROBE_EPOCHS)])
        k3_bench.update(n=SCALE_N, tile=SCALE_TILE, dtype="bfloat16", noise="hbm",
                        epochs=PROBE_EPOCHS)
        emit({"k3_vs_plain": {"kernel": "K3", **k3_bench}})
        if not ok:
            fail(f"K3 disagrees with its plain version at the bench shape: {k3_bench}")
        del probe, probe_plain
        if probe_ms * SCALE_EPOCHS / PROBE_EPOCHS <= 1e3 * PLAIN_BUDGET_S:
            plain_epochs = SCALE_EPOCHS
            k3_plain_ms, _ = cuda_ms(lambda: fs._fused_scale_call_plain(*args))
        else:
            plain_epochs = PROBE_EPOCHS
            k3_plain_ms = probe_ms * SCALE_EPOCHS / PROBE_EPOCHS
        del eps_all
        # the CLI's default: pure float32
        nv32, packed32 = fs._scale_inputs(ws, cfg, SCALE_TILE, None, None, dev)
        eps32 = fs.hbm_noise(0, SCALE_EPOCHS, packed32.shape[0], cfg.latent_dim, None, dev)
        k3_f32_ms, _ = cuda_ms(lambda: fs._fused_scale_call(
            plist, packed32, 0, cfg, lw, SCALE_EPOCHS, 1e-3, SCALE_TILE, float(nv32),
            None, "hbm", eps32))
        del eps32, packed32
        # the per-epoch tier through K4, and K4 alone
        fs._grad_epoch_call.launches = 0
        t0 = time.perf_counter()
        _, dhist = fs.fused_train_scale_dp(ws, epochs=SCALE_EPOCHS, tile=SCALE_TILE,
                                           compute_dtype="bfloat16", noise="hbm",
                                           seed=0, device=dev)
        torch.cuda.synchronize()
        dp_wall_s = time.perf_counter() - t0
        k4_launches = fs._grad_epoch_call.launches
        if k4_launches != SCALE_EPOCHS:
            fail(f"fused_train_scale_dp launched K4 {k4_launches} times, "
                 f"expected {SCALE_EPOCHS}")
        if not (np.all(np.isfinite(dhist["total"]))
                and dhist["total"][-1] < dhist["total"][0]):
            fail("the per-epoch tier did not descend")
        # K4 and its plain version, timed and held against each other
        e0 = fs.hbm_noise(0, 1, n_pad, cfg.latent_dim, "bfloat16", dev)
        gargs = (plist, packed, 0, cfg, lw, SCALE_TILE, float(nv), "bfloat16", "hbm", e0)
        k4_ms, k4_out = cuda_ms(lambda: fs._grad_epoch_call(*gargs), 3)
        k4_plain_ms, k4_plain = cuda_ms(lambda: fs._plain_grad_epoch(
            plist, packed, SCALE_TILE, cfg, lw, float(nv), "bfloat16",
            fs._eps_source("hbm", cfg, SCALE_TILE, n_pad, e0, 0, dev)))
        k4_bench, ok = k4_gaps(k4_out, k4_plain, K4_TOL["bfloat16"])
        k4_bench.update(n=SCALE_N, tile=SCALE_TILE, dtype="bfloat16", noise="hbm")
        emit({"k3_vs_plain": {"kernel": "K4", **k4_bench}})
        if not ok:
            fail(f"K4 disagrees with its plain version at the bench shape: {k4_bench}")
        del k4_out, k4_plain
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, sparams, cfg, "scale", shist)
            loaded, cfg2, _ = load_checkpoint(d, dev)
            same = all(torch.equal(loaded[k][q], sparams[k][q])
                       for k in sparams for q in ("w", "b"))
        if not same or cfg2 != cfg:
            fail("checkpoint round trip changed the production-scale params")
        info.update(n=SCALE_N, epochs=SCALE_EPOCHS, tile=SCALE_TILE, dtype="bfloat16",
                    noise="hbm", k3_launches=k3_launches, main_path_s=wall_s,
                    loss_first=float(tot[0]), loss_last=float(tot[-1]),
                    k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, plain_epochs_timed=plain_epochs,
                    k3_f32_ms=k3_f32_ms, windows_per_s=SCALE_N * SCALE_EPOCHS / (k3_ms / 1e3),
                    dp_wall_s=dp_wall_s, k4_launches=k4_launches, k4_ms=k4_ms,
                    k4_plain_ms=k4_plain_ms, dp_loss_last=float(dhist["total"][-1]),
                    card=card)

    # ---- 10. K2 and the seed grid against their plain versions ------------
    corpora = {k: np.load(scenarios.get(k).fixture_windows)
               for k in ("sce1", "sce2", "sce3", "sce4")}
    keys = sorted(corpora)

    def ragged(seeds):
        """The four corpora as fused_train_multi hands them to K2, with the
        runs' initial params from ``seeds``."""
        ins = [ft.fused_inputs(corpora[k], dev) for k in keys]
        off = np.concatenate([[0], np.cumsum([len(a) for a, _ in ins])]).tolist()
        st = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                                   for q in seeds])
        return (st, torch.cat([a for a, _ in ins]).contiguous(),
                torch.cat([b for _, b in ins]).contiguous(), off)

    k2_err, seeds_err = {}, {}
    with phase("k2_vs_plain", 120) as info:
        rows = []
        mseeds = list(range(len(keys)))
        st, x, c, off = ragged(mseeds)
        eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (x.shape[0], cfg.latent_dim)).astype(np.float32)).to(dev)
        for ep in (1, 50):
            plain = ft._fused_multi_call_plain(st, x, c, off, mseeds, cfg, lw, ep, 1e-3, eps)
            gaps, ok = grid_gaps(ft._fused_multi_call(st, x, c, off, mseeds, cfg, lw, ep,
                                                      1e-3, eps), plain, GRID_TOL[ep])
            row = {"kernel": "K2", "rows": off, "epochs": ep, **gaps}
            if ep > 1:
                row["plain_one_ulp"] = grid_gaps(ft._fused_multi_call_plain(
                    one_ulp(st), x, c, off, mseeds, cfg, lw, ep, 1e-3, eps), plain,
                    GRID_TOL[ep])[0]
            rows.append(row)
            emit({"k2_vs_plain": row})
            if not ok:
                fail(f"K2 disagrees with its plain version: {row}")
            k2_err["max_abs_err"] = gaps["params_max_abs"]
        x4, c4 = ft.fused_inputs(w4, dev)
        gseeds = [0, 1, 2, 3]
        st4 = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                                    for q in gseeds])
        eps4 = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (len(gseeds), len(w4), cfg.latent_dim)).astype(np.float32)).to(dev)
        gaps, ok = grid_gaps(ft._fused_seeds_call(st4, x4, c4, gseeds, cfg, lw, 50, 1e-3, eps4),
                             ft._fused_seeds_call_plain(st4, x4, c4, gseeds, cfg, lw, 50, 1e-3,
                                                        eps4), GRID_TOL[50])
        row = {"kernel": "K1 seed grid", "B": len(w4), "seeds": len(gseeds), "epochs": 50,
               **gaps}
        rows.append(row)
        emit({"k2_vs_plain": row})
        if not ok:
            fail(f"the seed grid disagrees with its plain version: {row}")
        seeds_err["max_abs_err"] = gaps["params_max_abs"]
        info["cases"] = len(rows)

    # ---- 11. multi: every scenario's model in one K2 launch ---------------
    with phase("multi", 300) as info:
        ft._fused_multi_call.launches = 0
        t0 = time.perf_counter()
        # K2's time: CUDA events around the main path's one launch
        k2_ms, (mparams, mhist) = cuda_ms(lambda: ft.fused_train_multi(
            corpora, epochs=DEPTH, seed=0, device=dev))
        multi_wall = time.perf_counter() - t0
        k2_launches, k2_cluster = ft._fused_multi_call.launches, ft._fused_multi_call.cluster
        if k2_launches != 1:
            fail(f"fused_train_multi launched K2 {k2_launches} times, expected 1")
        losses = converged(mhist, "fused_train_multi")
        # K2's plain version on the main path's inputs
        st, x, c, off = ragged(range(len(keys)))
        plain_part_ms, _ = cuda_ms(lambda: ft._fused_multi_call_plain(
            st, x, c, off, range(len(keys)), cfg, lw, PLAIN_MULTI_EPOCHS, 1e-3))
        k2_plain_ms = plain_part_ms * DEPTH / PLAIN_MULTI_EPOCHS
        # the ragged design: scenario i is fused_train with seed i, exactly
        p_chk, h_chk = ft.fused_train_multi(corpora, epochs=CHECK_EPOCHS, seed=0, device=dev)
        vs_single = {}
        for i, k in enumerate(keys):
            p1, h1 = ft.fused_train(corpora[k], epochs=CHECK_EPOCHS, seed=i, device=dev)
            vs_single[k] = {
                "params_max_abs": max(float((p_chk[k][n][q] - p1[n][q]).abs().max())
                                      for n in p1 for q in ("w", "b")),
                "metrics_max_abs": max(float(np.abs(h_chk[k][m] - h1[m]).max()) for m in h1)}
        gap = max(v["params_max_abs"] for v in vs_single.values())
        emit({"multi_vs_fused_train": {"epochs": CHECK_EPOCHS, "per_scenario": vs_single,
                                       "params_tol": K1_TOL[50]["params_abs"]}})
        if gap > K1_TOL[50]["params_abs"]:
            fail(f"K2's runs differ from fused_train per scenario by {gap}")
        # each scenario's model sampled and tracked with its own tracker
        tracked, seed0_traces = {}, {}
        for k in keys:
            sce = scenarios.get(k)
            starts_k, inits_k = fixture_starts(corpora[k])
            mpc_k = default_mpc_cfg(sce)
            t0 = time.perf_counter()
            traces_k, idx_k = generate_and_track_from_starts(mparams[k], cfg, starts_k, inits_k,
                                                             seed=0, mpc_cfg=mpc_k)
            if not len(traces_k):
                fail(f"no valid sample of the {k} model")
            tracked[k] = {"n_starts": len(starts_k), "n_tracked": len(traces_k),
                          "tracked_steps": check_tracked(traces_k, mpc_k, k),
                          "seconds": time.perf_counter() - t0}
            seed0_traces[k] = (traces_k, idx_k)
        k2_split = k1p.split(dev, "k2", SPLIT_EPOCHS)
        info.update(epochs=DEPTH, rows=off, k2_launches=k2_launches, main_path_s=multi_wall,
                    cluster=k2_cluster, timed_ms=k2_split[0], phases_ms=k2_split[1],
                    split_epochs=SPLIT_EPOCHS,
                    losses=losses, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
                    plain_epochs_timed=PLAIN_MULTI_EPOCHS, vs_fused_train_max_abs=gap,
                    tracked=tracked, card=card)

    # ---- 12. track_multi: several generation seeds in one tracking batch --
    with phase("track_multi", 120) as info:
        sce2 = scenarios.get("sce2")
        starts2, inits2 = fixture_starts(corpora["sce2"])
        mpc2 = default_mpc_cfg(sce2)
        gseeds = [0, 1, 2, 3]
        t0 = time.perf_counter()
        multi = generate_and_track_multi_from_starts(mparams["sce2"], cfg, starts2, inits2,
                                                     gseeds, mpc2)
        info["multi_s"] = time.perf_counter() - t0
        # the JAX package's tolerance for the same comparison
        # (tests/test_pipeline.py:99): sce2's coordinates are 108-186 m,
        # where one float32 ulp is 1.53e-5 m, and batched products of another
        # batch width may round a step's state an ulp or two apart
        worst, rows_n, close = 0.0, 0, True
        for q in gseeds:
            ref = (seed0_traces["sce2"] if q == 0 else generate_and_track_from_starts(
                mparams["sce2"], cfg, starts2, inits2, seed=q, mpc_cfg=mpc2))
            traces_q, idx_q = multi[q]
            if not np.array_equal(idx_q, ref[1]) or len(traces_q) != len(ref[0]):
                fail(f"multi-seed tracker kept other rows than seed {q}'s own call")
            check_tracked(traces_q, mpc2, f"multi-seed tracker, seed {q}")
            for a, b in zip(traces_q, ref[0]):
                if a.shape != b.shape:
                    fail(f"multi-seed tracker: another step count than seed {q}'s own call")
                worst = max(worst, float(np.abs(a[:, :2] - b[:, :2]).max()))
                close &= bool(np.allclose(a, b, rtol=1e-5, atol=1e-4))
            rows_n += len(traces_q)
        info.update(seeds=gseeds, rows=rows_n, pos_max_abs_m=worst, rtol=1e-5, atol=1e-4)
        if not close:
            fail(f"multi-seed tracker differs from per-seed tracking (pos {worst} m)")

    # ---- 13. seeds: the seed sweep in one launch of K1 on 32 blocks -------
    with phase("seeds", 300) as info:
        sweep = list(range(SWEEP_SEEDS))
        ft._fused_seeds_call.launches = 0
        t0 = time.perf_counter()
        # the grid's time: CUDA events around the main path's one launch
        seeds_ms, (_, swhist) = cuda_ms(lambda: ft.fused_train_seeds(
            w4, sweep, epochs=DEPTH, device=dev))
        seeds_wall = time.perf_counter() - t0
        seeds_launches, seeds_cluster = (ft._fused_seeds_call.launches,
                                         ft._fused_seeds_call.cluster)
        if seeds_launches != 1:
            fail(f"fused_train_seeds launched {seeds_launches} times, expected 1")
        losses = converged(swhist, "fused_train_seeds")
        x4, c4 = ft.fused_inputs(w4, dev)
        st = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                                   for q in sweep])
        st_p = tuple(a[:PLAIN_SEEDS] for a in st)
        plain_part_ms, _ = cuda_ms(lambda: ft._fused_seeds_call_plain(
            st_p, x4, c4, sweep[:PLAIN_SEEDS], cfg, lw, PLAIN_SEEDS_EPOCHS, 1e-3))
        seeds_plain_ms = (plain_part_ms * (SWEEP_SEEDS / PLAIN_SEEDS)
                          * (DEPTH / PLAIN_SEEDS_EPOCHS))
        # bit for bit against fused_train, at the main path's grid of 32
        p_chk, h_chk = ft.fused_train_seeds(w4, sweep, epochs=CHECK_EPOCHS, device=dev)
        for q in CHECK_SEEDS:
            p1, h1 = ft.fused_train(w4, epochs=CHECK_EPOCHS, seed=q, device=dev)
            if not (all(torch.equal(p_chk[q][n][k], p1[n][k]) for n in p1 for k in ("w", "b"))
                    and all(np.array_equal(h_chk[q][m], h1[m]) for m in h1)):
                fail(f"seed {q} of the seed grid is not fused_train's run bit for bit")
        seeds_split = k1p.split(dev, "grid", SPLIT_EPOCHS, seeds=SWEEP_SEEDS)
        info.update(seeds=SWEEP_SEEDS, epochs=DEPTH, B=len(w4), launches=seeds_launches,
                    cluster=seeds_cluster, timed_ms=seeds_split[0],
                    split_epochs=SPLIT_EPOCHS,
                    phases_ms=seeds_split[1],
                    main_path_s=seeds_wall, kernel_ms=seeds_ms, plain_ms=seeds_plain_ms,
                    plain_timed=[PLAIN_SEEDS, PLAIN_SEEDS_EPOCHS],
                    bit_identical_seeds=list(CHECK_SEEDS), check_epochs=CHECK_EPOCHS,
                    loss_first_max=max(v[0] for v in losses.values()),
                    loss_last_max=max(v[1] for v in losses.values()), card=card)

    # ---- 14. the K3 ablation's kernels against their plain versions --------
    abl_err = {}
    with phase("ablation_vs_plain", 150) as info:
        rows = []
        eps = np.random.default_rng(1).standard_normal((ABL_N, cfg.latent_dim)).astype(np.float32)
        nv, packed = fs._scale_inputs(scale_corpus(ABL_N), cfg, ABL_TILE, "bfloat16", eps, dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        for ep in (1, 3):
            args = (plist, packed, 3, cfg, lw, ep, 1e-3, ABL_TILE, float(nv), "bfloat16",
                    "packed", None)
            default = fs._fused_scale_call_plain(*args)
            for knob in fs.ABLATE_BITS:
                plain = fs._fused_scale_call_plain(*args, _ablate=(knob,))
                tol = NOACC_TOL[ep] if knob == "noacc" else K3_TOL[("bfloat16", ep)]
                gaps, ok = k3_gaps(fs._fused_scale_call(*args, _ablate=(knob,)), plain, tol)
                if ep == 1:
                    ggaps, gok = knob_grad_gaps(knob, args, K4_TOL["bfloat16"])
                    gaps.update({f"summed_{k}": v for k, v in ggaps.items()})
                    ok &= gok
                # how far the knob moves the run: after one epoch, those
                # that change the parameters must move some by more than a
                # tenth of a step
                off = max(float((a - b).abs().max()) for a, b in zip(plain[0], default[0]))
                row = {"kernel": "K3", "knob": knob, "epochs": ep, **gaps,
                       "plain_vs_no_knob_params_max_abs": off}
                rows.append(row)
                emit({"ablation_vs_plain": row})
                if not ok:
                    fail(f"K3 under {knob} disagrees with its plain version: {row}")
                if (ep == 1 and knob in ("noadam", "noacc", "nodw", "fwdonly")
                        and off <= STEP_TENTH):
                    fail(f"the {knob} knob does not change the run: {row}")
        # K3 and K4 with _ablate=() against their reference digests, bit
        # for bit (float32: the build before the tensor cores; bf16: the
        # tensor-core engine's)
        sms = k3d.sm_count(dev)
        ref, got = k3d.REFERENCE.get(sms), k3d.digests(dev, _ablate=())
        emit({"ablation_vs_plain": {"kernel": "K3/K4", "knob": "()", "sms": sms,
                                    "digests": got, "reference": ref,
                                    "bit_identical": got == ref}})
        if ref is None:
            fail(f"no reference digests of K3/K4 for a card of {sms} SMs")
        if got != ref:
            fail("K3/K4 with _ablate=() are not their reference build bit for bit")
        # P1 on the same corpus
        n_chain = sa.sol_chain_length(cfg)
        g = torch.Generator().manual_seed(5)
        w_in = (torch.randn((packed.shape[1], 128), generator=g)
                / packed.shape[1] ** 0.5).to(torch.bfloat16).to(dev)
        w_ch = (torch.randn((128, 128), generator=g) / 128 ** 0.5).to(torch.bfloat16).to(dev)
        for mode in ("stream", "sol", "fwd", "dx"):
            wrong = {}
            if mode == "stream":
                k, p = sa.p1_stream(packed, 3, ABL_TILE), sa._p1_stream_plain(packed, 3, ABL_TILE)
                scale = float(packed.float().abs().sum())
            elif mode == "sol":
                k = sa.p1_sol(packed, w_in, w_ch, n_chain, 3, ABL_TILE)
                p = sa._p1_sol_plain(packed, w_in, w_ch, n_chain, 3, ABL_TILE)
                scale = float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
            else:
                k = sa.p1_ablation(packed, plist, mode, cfg, lw, float(nv), 3, ABL_TILE)
                p = sa._p1_ablation_plain(packed, plist, mode, cfg, lw, float(nv), 3)
                scale = float(sa._dx_plain(packed, plist, cfg, lw, float(nv)).float().abs().sum())
            if mode in ("sol", "dx"):
                wrong = p1_wrong_sums(sa, ft, mode, packed, plist, cfg, lw, float(nv), w_in,
                                      w_ch, n_chain)
            row = {"kernel": f"P1-{mode}", "n": ABL_N, "epochs": 3,
                   "epochs_equal": bool(torch.equal(k[0], k[-1]))}
            ok, caught = row["epochs_equal"], True
            if mode in ("fwd", "dx"):
                rel = float(((k[:, :5] - p[:, :5]).abs() / p[:, :5].abs().clamp(min=1e-30)).max())
                row.update(loss_max_rel=rel, loss_tol=P1_TOL["fwd_rel"])
                ok &= rel <= P1_TOL["fwd_rel"]
            if mode != "fwd":
                srow, sok, caught = p1_sum_row(mode, k, p, scale, wrong)
                row.update(srow)
                ok &= sok
            rows.append(row)
            emit({"ablation_vs_plain": row})
            if not ok:
                fail(f"P1-{mode} disagrees with its plain version: {row}")
            if not caught:
                fail(f"P1-{mode}'s limit passes a wrong plain version: {row}")
        # P2 at the full stream, four calls on one workspace: the second on
        # the stream negated, whose sum is the first's negated bit for bit
        # (every rounding is symmetric), so each call must write its row
        # from its own partials; the third and fourth must give the first's
        # bits (the last block reset the ticket)
        eps2 = fs.hbm_noise(5, P2_EPOCHS, SCALE_N, cfg.latent_dim, "bfloat16", dev)
        k = sa.p2_stream_sum(eps2, SCALE_TILE)
        neg = -eps2
        k_neg = sa.p2_stream_sum(neg, SCALE_TILE)
        del neg
        again = [sa.p2_stream_sum(eps2, SCALE_TILE) for _ in range(2)]
        p = sa._p2_plain(eps2, SCALE_TILE)
        scale = float(eps2.float().abs().sum())
        gap, tol = float((k - p).abs().max()), P2_TOL * scale
        grid = sa._P2_WS[(eps2.device.index, sa._stream(eps2.device))][2]
        wrong, shares = p2_wrong_sums(eps2, grid, float(p[0, 0]))
        wrong_gaps = {w: abs(v - float(p[0, 0])) for w, v in wrong.items()}
        row = {"kernel": "P2", "rows": eps2.shape[0], "bytes": eps2.numel() * 2,
               "kernel_sum": float(k[0, 0]), "plain_sum": float(p[0, 0]), "sum_gap": gap,
               "abs_terms": scale, "tol": tol, "tol_frac": P2_TOL,
               "lanes_equal": bool(torch.all(k == k[0, 0])),
               "negated_bits_equal": bool(torch.equal(k_neg, -k)),
               "repeat_bits_equal": all(bool(torch.equal(a, k)) for a in again),
               "wrong_gaps": wrong_gaps,
               "wrong_gaps_frac": {w: v / scale for w, v in wrong_gaps.items()},
               # how many blocks' partials the limit would miss, were each left out
               "blocks": len(shares),
               "blocks_within_tol": int((shares.abs() <= tol).sum())}
        rows.append(row)
        emit({"ablation_vs_plain": row})
        if not (gap <= tol and row["lanes_equal"] and row["negated_bits_equal"]
                and row["repeat_bits_equal"]):
            fail(f"P2 disagrees with its plain version or with itself: {row}")
        if not all(v > tol for v in wrong_gaps.values()):
            fail(f"P2's limit passes a wrong plain version: {row}")
        abl_err["p2"] = gap
        del eps2, shares
        info["cases"] = len(rows)

    # ---- 15. ablation: the ported K3 ablation at the bench width -----------
    with phase("ablation", 300) as info:
        counters = (fs._fused_scale_call, sa.p1_stream, sa.p1_sol, sa.p1_ablation,
                    sa.p2_stream_sum)
        for f in counters:
            f.launches = 0
        fs._fused_scale_call.knob_launches = dict.fromkeys(fs.ABLATE_BITS, 0)
        fs._fused_scale_call.auto_launches = dict.fromkeys(fs.AUTO_MODES, 0)
        sa.p1_ablation.mode_launches = dict.fromkeys(sa.P1_MODES, 0)
        cuda_before = sa.cuda_launches()
        t0 = time.perf_counter()
        out, last = sab.run_ablation(SCALE_N, ABL_EPOCHS, SCALE_TILE, ABL_REPS, dev)
        abl_wall = time.perf_counter() - t0
        probe_rc = ncp.main(["--reps", str(ABL_REPS)])  # prints its own line
        abl_launches = {f.__name__: f.launches for f in counters}
        abl_launches.update({f"p1_ablation_{m}": c
                             for m, c in sa.p1_ablation.mode_launches.items()})
        abl_launches.update(k3_dwT=fs._fused_scale_call.knob_launches["dwT"],
                            k3_auto_f32_acts=fs._fused_scale_call.auto_launches["f32_acts"])
        # the CUDA launches the C entries issued, as they counted them
        abl_cuda = {k: v - cuda_before[k] for k, v in sa.cuda_launches().items()}
        emit({"scale_ablation": out})
        if probe_rc != 0:
            fail("the noise consumer probe failed")
        idle = sorted(k for k, c in {**abl_launches, **abl_cuda}.items() if c == 0)
        if idle:
            fail(f"the ablation's main path launched none of {idle}")
        if abl_cuda["p2"] != abl_launches["p2_stream_sum"]:
            fail(f"P2 issued {abl_cuda['p2']} CUDA launches for "
                 f"{abl_launches['p2_stream_sum']} calls (one a call)")
        for v, m in last.items():
            if not np.all(np.isfinite(m)):
                fail(f"ablation variant {v}: non-finite metrics")
        fw, dx, me, fe, hb = (last[k] for k in ("fwd", "dx", "manual_eps", "full_eps", "hbm"))
        if not (np.allclose(fw[0, :5], fw[-1, :5], rtol=1e-4)
                and np.allclose(dx[0, :5], fw[0, :5], rtol=1e-4)
                and np.allclose(me[0, :5], fw[0, :5], rtol=1e-4)
                and np.allclose(fe[0, :5], fw[0, :5], rtol=1e-4)
                and hb[-1, 0] < hb[0, 0] and me[-1, 0] < me[0, 0] and fe[-1, 0] < fe[0, 0]):
            fail("ablation variants disagree on the epoch-0 loss or do not descend")
        # P1 at the bench width against its plain versions over the first
        # epochs, each timed (plain scaled to ABL_EPOCHS), and the library call
        rng = np.random.default_rng(7)
        nv, packed = fs._scale_inputs(ws, cfg, SCALE_TILE, "bfloat16",
                                      rng.standard_normal((SCALE_N, cfg.latent_dim))
                                      .astype(np.float32), dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        g = torch.Generator().manual_seed(5)
        w_in = (torch.randn((packed.shape[1], 128), generator=g)
                / packed.shape[1] ** 0.5).to(torch.bfloat16).to(dev)
        w_ch = (torch.randn((128, 128), generator=g) / 128 ** 0.5).to(torch.bfloat16).to(dev)
        n_chain = sa.sol_chain_length(cfg)
        E, scale_up = ABL_PLAIN_EPOCHS, ABL_EPOCHS / ABL_PLAIN_EPOCHS
        p1_res = {}
        for mode, kern, plain in (
                ("stream", lambda: sa.p1_stream(packed, E, SCALE_TILE),
                 lambda: sa._p1_stream_plain(packed, E, SCALE_TILE)),
                ("sol", lambda: sa.p1_sol(packed, w_in, w_ch, n_chain, E, SCALE_TILE),
                 lambda: sa._p1_sol_plain(packed, w_in, w_ch, n_chain, E, SCALE_TILE)),
                ("fwd", lambda: sa.p1_ablation(packed, plist, "fwd", cfg, lw, float(nv), E,
                                               SCALE_TILE),
                 lambda: sa._p1_ablation_plain(packed, plist, "fwd", cfg, lw, float(nv), E)),
                ("dx", lambda: sa.p1_ablation(packed, plist, "dx", cfg, lw, float(nv), E,
                                              SCALE_TILE),
                 lambda: sa._p1_ablation_plain(packed, plist, "dx", cfg, lw, float(nv), E))):
            k = kern()
            p1_plain_ms, p = cuda_ms(plain)
            res = {}
            if mode == "fwd":
                err = float((k[:, :5] - p[:, :5]).abs().max())
                ok, caught = (float(((k[:, :5] - p[:, :5]).abs() / p[:, :5].abs()).max())
                              <= P1_TOL["fwd_rel"]), True
            else:
                terms = (float(packed.float().abs().sum()) if mode == "stream" else
                         float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
                         if mode == "sol" else
                         float(sa._dx_plain(packed, plist, cfg, lw, float(nv)).float().abs().sum()))
                wrong = ({} if mode == "stream" else
                         p1_wrong_sums(sa, ft, mode, packed, plist, cfg, lw, float(nv), w_in,
                                       w_ch, n_chain))
                res, ok, caught = p1_sum_row(mode, k, p, terms, wrong)
                err = res["sum_gap"]
            if not ok:
                fail(f"P1-{mode} disagrees with its plain version at the bench width: "
                     f"{err} {res}")
            if not caught:
                fail(f"P1-{mode}'s limit passes a wrong plain version at the bench width: {res}")
            p1_res[mode] = {"max_abs_err": err, "plain_ms": p1_plain_ms * scale_up,
                            "ms": 1e3 * out["variants"][mode]["best_s"], **res}
        p1_res["stream"]["library_ms"] = cuda_ms(
            lambda: [torch.sum(packed, dtype=torch.float32) for _ in range(ABL_EPOCHS)])[0]
        del packed
        eps2 = fs.hbm_noise(6, P2_EPOCHS, SCALE_N, cfg.latent_dim, "bfloat16", dev)

        def p2_wrapper(fn):
            return cuda_ms(lambda: [fn() for _ in range(P2_WRAPPER_CALLS)])[0] / P2_WRAPPER_CALLS

        def p2_device(fn):
            return device_ms(lambda: [fn() for _ in range(P2_DEVICE_LAUNCHES)],
                             P2_DEVICE_LAUNCHES)

        def p2_call():
            return sa.p2_stream_sum(eps2, SCALE_TILE)

        def p2_lib():
            return torch.sum(eps2, dtype=torch.float32)

        p2_wrapper(p2_call), p2_wrapper(p2_lib)  # warm
        p2_med, p2_spread = in_turns(lambda: p2_wrapper(p2_call), lambda: p2_wrapper(p2_lib))
        p2_dev_med, p2_dev_spread = in_turns(lambda: p2_device(p2_call),
                                             lambda: p2_device(p2_lib))
        p2_plain_ms, _ = cuda_ms(lambda: sa._p2_plain(eps2, SCALE_TILE), 3)
        del eps2
        p2_ms, p2_lib_ms = p2_med["kernel"], p2_med["library"]
        p2_timing = {"ms": p2_ms, "device_ms": p2_dev_med["kernel"], "library_ms": p2_lib_ms,
                     "library_device_ms": p2_dev_med["library"],
                     "spread": {"ms": p2_spread["kernel"], "device_ms": p2_dev_spread["kernel"],
                                "library_ms": p2_spread["library"],
                                "library_device_ms": p2_dev_spread["library"]}}
        # K3 under dwT at the bench width against its plain version over the
        # first E epochs, the plain version timed and scaled to ABL_EPOCHS
        nv_h, packed_h = fs._scale_inputs(ws, cfg, SCALE_TILE, "bfloat16", None, dev)
        eps_h = fs.hbm_noise(0, E, packed_h.shape[0], cfg.latent_dim, "bfloat16", dev)
        dargs = (plist, packed_h, 0, cfg, lw, E, 1e-3, SCALE_TILE, float(nv_h), "bfloat16",
                 "hbm", eps_h)
        dwt_plain_ms, dwt_plain = cuda_ms(
            lambda: fs._fused_scale_call_plain(*dargs, _ablate=("dwT",)))
        dwt_plain_ms *= scale_up
        dwt_bench, ok = k3_gaps(fs._fused_scale_call(*dargs, _ablate=("dwT",)), dwt_plain,
                                K3_TOL[("bfloat16", E)])
        dwt_bench.update(kernel="K3 under dwT", n=SCALE_N, tile=SCALE_TILE, noise="hbm",
                         epochs=E)
        emit({"ablation_vs_plain": dwt_bench})
        if not ok:
            fail(f"K3 under dwT disagrees with its plain version at the bench width: "
                 f"{dwt_bench}")
        del packed_h, eps_h, dwt_plain
        dwt_ms = 1e3 * out["variants"]["hbm_dwT"]["best_s"]
        info.update(n=SCALE_N, epochs=ABL_EPOCHS, tile=SCALE_TILE, reps=ABL_REPS,
                    main_path_s=abl_wall, launches=abl_launches, cuda_launches=abl_cuda,
                    p1=p1_res, p2=p2_timing, p2_plain_ms=p2_plain_ms,
                    dwt_plain_ms=dwt_plain_ms, dwt_vs_plain=dwt_bench, card=card)

    # ---- 16. train_auto: K1's autodiff instance on the main path ---------
    with phase("train_auto", 120) as info:
        ft.fused_call.auto_launches = 0
        t0 = time.perf_counter()
        k1a_ms, (aparams, ahist) = cuda_ms(lambda: ft.fused_train(
            w4, epochs=epochs, lr=1e-3, weights=lw, seed=0, backward="auto", device=dev))
        k1a_wall = time.perf_counter() - t0
        k1a_launches, k1a_cluster = ft.fused_call.auto_launches, ft.fused_call.cluster
        if k1a_launches != 1:
            fail(f"fused_train(backward='auto') launched K1-auto {k1a_launches} times")
        tot = ahist["total"]
        if not (np.all(np.isfinite(np.stack(list(ahist.values())))) and tot[-1] < tot[0] / 5):
            fail(f"K1-auto's run did not converge: {tot[0]} -> {tot[-1]}")
        x, c = ft.fused_inputs(w4, dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        k1a_plain_ms = cuda_ms(lambda: ft._fused_call_plain(
            plist, x, c, 0, cfg, lw, PLAIN_K1_EPOCHS, 1e-3, None,
            backward="auto"))[0] * epochs / PLAIN_K1_EPOCHS
        # the 3000-epoch main paths, auto and manual from one init and one
        # noise stream: their gap is the chaos of 3000 Adam steps, printed
        k1a_vs_manual = max(float((aparams[k][q] - params[k][q]).abs().max())
                            for k in params for q in ("w", "b"))
        k1a_split = k1p.split(dev, "k1_auto", SPLIT_EPOCHS)
        info.update(epochs=epochs, B=len(w4), launches=k1a_launches, main_path_s=k1a_wall,
                    cluster=k1a_cluster, timed_ms=k1a_split[0], phases_ms=k1a_split[1],
                    split_epochs=SPLIT_EPOCHS,
                    kernel_ms=k1a_ms, plain_ms=k1a_plain_ms,
                    loss_first=float(tot[0]), loss_last=float(tot[-1]),
                    manual_loss_last=float(hist["total"][-1]),
                    vs_manual_3000_epochs_params_max_abs=k1a_vs_manual, card=card)

    # ---- 17. auto_vs_plain: the autodiff instances against their plain versions
    with phase("auto_vs_plain", 150) as info:
        rows = []

        def held(row, ok, what):
            rows.append(row)
            emit({"auto_vs_plain": row})
            if not ok:
                fail(f"{what} disagrees with its plain version: {row}")

        # K1-auto, sce4, explicit ε, 1 and 50 epochs
        eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (len(w4), cfg.latent_dim)).astype(np.float32)).to(dev)
        for ep in (1, 50):
            pk, mk = ft.fused_call(plist, x, c, 0, cfg, lw, ep, 1e-3, eps, backward="auto")
            pp, mp = ft._fused_call_plain(plist, x, c, 0, cfg, lw, ep, 1e-3, eps,
                                          backward="auto")
            p_abs = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
            m_rel = float(((mk[:, :5] - mp[:, :5]).abs() / mp[:, :5].abs().clamp(min=1e-6)).max())
            tol = K1_TOL[ep]
            held({"kernel": "K1-auto", "B": len(w4), "epochs": ep, "params_max_abs": p_abs,
                  "params_tol": tol["params_abs"], "metrics_max_rel": m_rel,
                  "metrics_tol": tol["metrics_rel"]},
                 p_abs <= tol["params_abs"] and m_rel <= tol["metrics_rel"], "K1-auto")
            k1a_err = p_abs
        # K1-auto against K1-manual over JAX's run (printed, not held)
        ep = K1_AUTO_VS_MANUAL["epochs"]
        pa, _ = ft.fused_call(plist, x, c, 0, cfg, lw, ep, 1e-3, eps, backward="auto")
        pm, _ = ft.fused_call(plist, x, c, 0, cfg, lw, ep, 1e-3, eps)
        gap = max(float((a - b).abs().max()) for a, b in zip(pa, pm))
        row = {"kernel": "K1-auto vs K1-manual", "epochs": ep, "params_max_abs": gap,
               "jax_bound": K1_AUTO_VS_MANUAL["params_abs"],
               "within_jax_bound": gap <= K1_AUTO_VS_MANUAL["params_abs"],
               "main_paths_3000_epochs_params_max_abs": k1a_vs_manual}
        rows.append(row)
        emit({"auto_vs_plain": row})
        # K2-auto and the seed grid under auto: each run bit for bit K1-auto
        mp_a, mh_a = ft.fused_train_multi(corpora, epochs=AUTO_CHECK_EPOCHS, seed=0,
                                          backward="auto", device=dev)
        sp_a, sh_a = ft.fused_train_seeds(w4, CHECK_SEEDS, epochs=AUTO_CHECK_EPOCHS,
                                          backward="auto", device=dev)
        same = {}
        for runs, hists, one in ((mp_a, mh_a, lambda i, k: ft.fused_train(
                corpora[k], epochs=AUTO_CHECK_EPOCHS, seed=i, backward="auto", device=dev)),
                                 (sp_a, sh_a, lambda i, k: ft.fused_train(
                w4, epochs=AUTO_CHECK_EPOCHS, seed=k, backward="auto", device=dev))):
            for i, k in enumerate(runs):
                p1, h1 = one(i, k)
                same[str(k)] = (all(torch.equal(runs[k][n][q], p1[n][q]) for n in p1
                                    for q in ("w", "b"))
                                and all(np.array_equal(hists[k][m], h1[m]) for m in h1))
        held({"kernel": "K2-auto and the seed grid under auto vs K1-auto",
              "epochs": AUTO_CHECK_EPOCHS, "bit_identical": same}, all(same.values()),
             "K2-auto or the auto seed grid")
        # and against their own plain versions, as k2_vs_plain holds K2 and the grid
        st, xr, cr, off = ragged(range(len(keys)))
        er = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (xr.shape[0], cfg.latent_dim)).astype(np.float32)).to(dev)
        for ep in (1, 50):
            gaps, ok = grid_gaps(
                ft._fused_multi_call(st, xr, cr, off, range(len(keys)), cfg, lw, ep, 1e-3,
                                     er, backward="auto"),
                ft._fused_multi_call_plain(st, xr, cr, off, range(len(keys)), cfg, lw, ep,
                                           1e-3, er, backward="auto"), GRID_TOL[ep])
            held({"kernel": "K2-auto", "rows": off, "epochs": ep, **gaps}, ok, "K2-auto")
        gseeds = [0, 1, 2, 3]
        st4 = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                                    for q in gseeds])
        eps4 = torch.as_tensor(np.random.default_rng(9).standard_normal(
            (len(gseeds), len(w4), cfg.latent_dim)).astype(np.float32)).to(dev)
        gaps, ok = grid_gaps(
            ft._fused_seeds_call(st4, x, c, gseeds, cfg, lw, 50, 1e-3, eps4, backward="auto"),
            ft._fused_seeds_call_plain(st4, x, c, gseeds, cfg, lw, 50, 1e-3, eps4,
                                       backward="auto"), GRID_TOL[50])
        held({"kernel": "K1-auto seed grid", "B": len(w4), "seeds": len(gseeds), "epochs": 50,
              **gaps}, ok, "the seed grid under auto")
        # K3-auto in its three modes at 8,448 rows, tiles of 352, 1 and 3 epochs
        weps = np.random.default_rng(1).standard_normal((ABL_N, cfg.latent_dim)).astype(np.float32)
        wabl = scale_corpus(ABL_N)
        for cd, style in ((None, "f32_acts"), ("bfloat16", "f32_acts"),
                          ("bfloat16", "bf16_chain")):
            nv, packed = fs._scale_inputs(wabl, cfg, ABL_TILE, cd, weps, dev)
            for ep in (1, 3):
                args = (plist, packed, 3, cfg, lw, ep, 1e-3, ABL_TILE, float(nv), cd, "packed",
                        None)
                gaps, ok = k3_gaps(
                    fs._fused_scale_call(*args, backward="auto", mixed_style=style),
                    fs._fused_scale_call_plain(*args, backward="auto", mixed_style=style),
                    k3_auto_tol(cd, ep))
                held({"kernel": "K3-auto", "mode": fs._auto_mode(cd, style), "n": ABL_N,
                      "tile": ABL_TILE, "epochs": ep, **gaps}, ok, "K3-auto")
        # the one-tile limit against the plain version's own order noise on
        # the card: TILE_FRAC must lie above it on every corpus
        noise, noise_rows = tile_order_noise(fs, ft, scale_corpus, plist, cfg, lw, dev)
        held({"check": "plain order noise, one tile", "max_frac_over_ulps": noise,
              "frac_tol": TILE_FRAC, "cases": noise_rows}, noise <= TILE_FRAC,
             "the one-tile limit lies above the plain version's own order noise")
        # K4-auto on one tile of eleven 32-row steps: the per-tile rounding
        n1 = 352
        nv1, packed1 = fs._scale_inputs(scale_corpus(n1), cfg, n1, "bfloat16", weps[:n1], dev)
        src1 = fs._eps_source("packed", cfg, n1, n1, None, 0, dev)
        for style in ("f32_acts", "bf16_chain"):
            gk, rk = fs._grad_epoch_call(plist, packed1, 0, cfg, lw, n1, float(nv1), "bfloat16",
                                         "packed", None, "auto", style)
            gp, rp = fs._plain_grad_epoch(plist, packed1, n1, cfg, lw, float(nv1), "bfloat16",
                                          src1, backward="auto", mixed_style=style)
            row, ok = tile_rounding_gaps(gk, gp, style)
            r_rel = float(((rk[0, :5] - rp).abs() / rp.abs().clamp(min=1e-6)).max())
            ok &= r_rel <= K4_TOL["bfloat16"]["row_rel"]
            wrong = {k: tile_rounding_gaps(g, gp, style)
                     for k, g in wrong_tile_grads(fs, ft, plist, packed1, cfg, lw, float(nv1),
                                                  style).items()}
            held({"kernel": "K4-auto, one tile", "mode": style, "n": n1, "steps": n1 // 32,
                  **row, "row_max_rel": r_rel,
                  "wrong_versions": {k: {**r, "passes": o} for k, (r, o) in wrong.items()}},
                 ok, "K4-auto's per-tile rounding")
            if any(o for _, o in wrong.values()):
                fail(f"the one-tile check passes a wrong plain version: {wrong}")
            if style == "f32_acts":
                k4a_tile = row
        # K4-auto on three such tiles: the tiles' rounded sums added in order
        nt = TILES_N * n1
        nv3, packed3 = fs._scale_inputs(scale_corpus(nt), cfg, n1, "bfloat16", weps[:nt], dev)
        src3 = fs._eps_source("packed", cfg, n1, nt, None, 0, dev)
        parts = [packed3[i:i + n1] for i in range(0, nt, n1)]
        for style in ("f32_acts", "bf16_chain"):
            def k4a(pk, style=style):
                return fs._grad_epoch_call(plist, pk, 0, cfg, lw, n1, float(nv3), "bfloat16",
                                           "packed", None, "auto", style)

            def wrong_of(pk, tile=None, style=style):
                return wrong_tile_grads(fs, ft, plist, pk, cfg, lw, float(nv3), style, tile,
                                        cross=True)
            gk, rk = k4a(packed3)
            gp, rp = fs._plain_grad_epoch(plist, packed3, n1, cfg, lw, float(nv3), "bfloat16",
                                          src3, backward="auto", mixed_style=style)
            sums = tile_sums(fs, plist, packed3, n1, cfg, lw, float(nv3), style)
            row, ok = tiles_added_gaps(gk, [k4a(pk)[0] for pk in parts], sums, style)
            order = per_tile_rows(reordered_tile_sums(fs, ft, plist, packed3, n1, cfg, lw,
                                                      float(nv3), style), sums, style)
            r_rel = float(((rk[0, :5] - rp).abs() / rp.abs().clamp(min=1e-6)).max())
            ok &= r_rel <= K4_TOL["bfloat16"]["row_rel"]
            w_whole, w_parts = wrong_of(packed3, n1), [wrong_of(pk) for pk in parts]
            wrong = {k: tiles_added_gaps(g, [w[k] for w in w_parts], sums, style)
                     for k, g in w_whole.items()}
            held({"kernel": "K4-auto, three tiles", "mode": style, "n": nt, "tile": n1,
                  **row, "row_max_rel": r_rel,
                  "vs_plain_in_tile_ulps": tiles_rounding_gaps(gk, gp, sums, style)[0],
                  "plain_reordered_per_tile": order,
                  "wrong_versions": {k: {**r, "passes": o} for k, (r, o) in wrong.items()}},
                 ok, "K4-auto's cross-tile sum")
            if any(o for _, o in wrong.values()):
                fail(f"the three-tile check passes a wrong plain version: {wrong}")
        # dwT: K3 under the knob is the default bit for bit
        nv, packed = fs._scale_inputs(wabl, cfg, ABL_TILE, "bfloat16", weps, dev)
        args = (plist, packed, 3, cfg, lw, 3, 1e-3, ABL_TILE, float(nv), "bfloat16", "packed",
                None)
        a_out, b_out = fs._fused_scale_call(*args), fs._fused_scale_call(*args, _ablate=("dwT",))
        dwt_same = (all(torch.equal(p, q) for p, q in zip(a_out[0], b_out[0]))
                    and bool(torch.equal(a_out[1], b_out[1])))
        held({"kernel": "K3 under dwT vs the default", "epochs": 3, "bit_identical": dwt_same},
             dwt_same, "K3 under dwT")
        del packed, packed1, packed3
        info["cases"] = len(rows)

    # ---- 18. train_scale_auto: the CLI's --backward auto at the bench shape
    with phase("train_scale_auto", 180) as info:
        fs._fused_scale_call.auto_launches = dict.fromkeys(fs.AUTO_MODES, 0)
        cli_runs = {}
        with tempfile.TemporaryDirectory() as d:
            wpath = os.path.join(d, "bench.npy")
            np.save(wpath, ws)
            for mode, dtype in (("f32_acts", ["--dtype", "bfloat16"]), ("float32", [])):
                before = dict(fs._fused_scale_call.auto_launches)
                ck = os.path.join(d, mode)
                t0 = time.perf_counter()
                ms, _ = cuda_ms(lambda: cli.main([
                    "train", "--scenario", "bench", "--windows", wpath, "--ckpt", ck,
                    "--epochs", str(SCALE_EPOCHS), "--tile", str(SCALE_TILE), "--fused-scale",
                    "--backward", "auto", "--noise", "prng", "--seed", "0", *dtype]))
                wall = time.perf_counter() - t0
                n_l = fs._fused_scale_call.auto_launches[mode] - before[mode]
                with open(os.path.join(ck, "manifest.json")) as f:
                    recipe = json.load(f)["recipe"]
                h = np.load(os.path.join(ck, "history.npz"))["total"]
                if n_l != 1 or recipe["backward"] != "auto":
                    fail(f"--backward auto ({mode}) launched K3-auto {n_l} times, recipe "
                         f"{recipe}")
                if not (np.all(np.isfinite(h)) and h[-1] < h[0]):
                    fail(f"--backward auto ({mode}) did not descend: {h[0]} -> {h[-1]}")
                cli_runs[mode] = {"launches": n_l, "ms": ms, "wall_s": wall,
                                  "loss_first": float(h[0]), "loss_last": float(h[-1])}
        # bf16_chain, the scan trainer's recipe, at the same shape
        before = fs._fused_scale_call.auto_launches["bf16_chain"]
        ms, (_, chist) = cuda_ms(lambda: fs.fused_train_scale(
            ws, epochs=SCALE_EPOCHS, tile=SCALE_TILE, compute_dtype="bfloat16",
            mixed_style="bf16_chain", noise="prng", seed=0, device=dev))
        n_l = fs._fused_scale_call.auto_launches["bf16_chain"] - before
        h = chist["total"]
        if n_l != 1 or not (np.all(np.isfinite(h)) and h[-1] < h[0]):
            fail(f"bf16_chain: {n_l} launches, loss {h[0]} -> {h[-1]}")
        cli_runs["bf16_chain"] = {"launches": n_l, "ms": ms, "loss_first": float(h[0]),
                                  "loss_last": float(h[-1])}
        # each instance timed alone over the run (CUDA events around its one
        # launch), and held against its plain version over the first epochs
        # of the same shape, the plain version timed and scaled to the run
        auto_bench = {}
        for mode, cd, style in (("f32_acts", "bfloat16", "f32_acts"),
                                ("float32", None, "f32_acts"),
                                ("bf16_chain", "bfloat16", "bf16_chain")):
            nv, packed = fs._scale_inputs(ws, cfg, SCALE_TILE, cd, None, dev)
            args = (plist, packed, 0, cfg, lw, AUTO_PROBE_EPOCHS, 1e-3, SCALE_TILE, float(nv),
                    cd, "prng", None)
            ms, _ = cuda_ms(lambda: fs._fused_scale_call(
                *args[:5], SCALE_EPOCHS, *args[6:], backward="auto", mixed_style=style))
            pms, plain = cuda_ms(lambda: fs._fused_scale_call_plain(
                *args, backward="auto", mixed_style=style))
            gaps, ok = k3_gaps(fs._fused_scale_call(*args, backward="auto", mixed_style=style),
                               plain, k3_auto_tol(cd, AUTO_PROBE_EPOCHS))
            gaps.update(mode=mode, n=SCALE_N, tile=SCALE_TILE, noise="prng",
                        epochs=AUTO_PROBE_EPOCHS)
            emit({"auto_vs_plain": {"kernel": "K3-auto", **gaps}})
            if not ok:
                fail(f"K3-auto ({mode}) disagrees with its plain version at the bench shape: "
                     f"{gaps}")
            auto_bench[mode] = {"max_abs_err": gaps["params_max_abs"], "ms": ms,
                                "plain_ms": pms * SCALE_EPOCHS / AUTO_PROBE_EPOCHS}
            del packed, plain
        # the per-epoch tier through K4-auto (depth cut), K4-auto timed and held
        fs._grad_epoch_call.auto_launches = dict.fromkeys(fs.AUTO_MODES, 0)
        t0 = time.perf_counter()
        _, dh = fs.fused_train_scale_dp(ws, epochs=AUTO_DP_EPOCHS, tile=SCALE_TILE,
                                        compute_dtype="bfloat16", noise="prng",
                                        backward="auto", seed=0, device=dev)
        torch.cuda.synchronize()
        k4a_wall = time.perf_counter() - t0
        k4a_launches = fs._grad_epoch_call.auto_launches["f32_acts"]
        if k4a_launches != AUTO_DP_EPOCHS or not (np.all(np.isfinite(dh["total"]))
                                                 and dh["total"][-1] < dh["total"][0]):
            fail(f"the per-epoch tier under auto: {k4a_launches} K4-auto launches, loss "
                 f"{dh['total'][0]} -> {dh['total'][-1]}")
        nv, packed = fs._scale_inputs(ws, cfg, SCALE_TILE, "bfloat16", None, dev)
        gargs = (plist, packed, 0, cfg, lw, SCALE_TILE, float(nv), "bfloat16", "prng", None,
                 "auto")
        k4a_ms, k4a_out = cuda_ms(lambda: fs._grad_epoch_call(*gargs), 3)
        k4a_plain_ms, k4a_plain = cuda_ms(lambda: fs._plain_grad_epoch(
            plist, packed, SCALE_TILE, cfg, lw, float(nv), "bfloat16",
            fs._eps_source("prng", cfg, SCALE_TILE, packed.shape[0], None, 0, dev),
            backward="auto"))
        k4a_bench, ok = k4_gaps(k4a_out, k4a_plain, K4_TOL["bfloat16"])
        emit({"auto_vs_plain": {"kernel": "K4-auto", "n": SCALE_N, **k4a_bench}})
        if not ok:
            fail(f"K4-auto disagrees with its plain version at the bench shape: {k4a_bench}")
        del packed, k4a_out, k4a_plain
        info.update(n=SCALE_N, epochs=SCALE_EPOCHS, tile=SCALE_TILE, noise="prng",
                    runs=cli_runs, bench_vs_plain=auto_bench, dp_epochs=AUTO_DP_EPOCHS,
                    dp_wall_s=k4a_wall, k4_launches=k4a_launches, k4_ms=k4a_ms,
                    k4_plain_ms=k4a_plain_ms, card=card)

    # ---- 19. scan_bf16: the scan trainer's bf16 chain and its siblings -----
    with phase("scan_bf16", 180) as info:
        extra = np.linspace(0.0, 1.0, len(w4), dtype=np.float32)[:, None]
        runs = {
            "train_sce4": lambda cd: {"sce4": train(
                w4, train_cfg=TrainConfig(epochs=SCAN_EPOCHS, compute_dtype=cd),
                device=dev)[1]},
            "train_multi_scenario": lambda cd: train_multi_scenario(
                corpora, TrainConfig(epochs=SCAN_EPOCHS, compute_dtype=cd), device=dev)[1],
            "train_conditioned_sce4": lambda cd: {"sce4": train_conditioned(
                w4, extra, TrainConfig(epochs=SCAN_EPOCHS, compute_dtype=cd), device=dev)[1]},
        }
        scan_out = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            h16 = run("bfloat16")
            t16 = time.perf_counter() - t0
            t0 = time.perf_counter()
            h32 = run(None)
            t32 = time.perf_counter() - t0
            res = {"bf16_s": t16, "float32_s": t32}
            for k in h16:
                a, b = h16[k]["total"], h32[k]["total"]
                res[k] = {"bf16_first": float(a[0]), "bf16_last": float(a[-1]),
                          "float32_last": float(b[-1]), "band": SCAN_BF16_BAND}
                if not (np.all(np.isfinite(a)) and a[-1] < a[0]
                        and a[-1] < SCAN_BF16_BAND * b[-1]):
                    fail(f"{name} in bf16 ({k}) outside its band: {res[k]}")
            scan_out[name] = res
        info.update(epochs=SCAN_EPOCHS, runs=scan_out, card=card)

    # ---- 20. k1_digest: the K1 family bit for bit the one-block build ---------
    with phase("k1_digest", 120) as info:
        ref = k1d.reference(torch.cuda.get_device_properties(dev).multi_processor_count)
        runs = {"picked": k1d.digests(dev)}
        for cs in K1_FORCED_SIZES:
            runs[str(cs)] = k1d.digests(dev, ["k1_manual_e50"], cs)
        bad = {k: k1d.mismatches(v, ref) for k, v in runs.items()}
        info.update(cases=len(runs["picked"]), forced_sizes=list(K1_FORCED_SIZES),
                    mismatches=bad, card=card)
        if any(bad.values()):
            fail(f"the K1 family differs from the one-block build's digests: {bad}")

    # ---- 21. serve: the four committed models behind one HTTP endpoint -------
    with phase("serve", 150) as info:
        info.update(serve_phase(np, torch, dev, w4, card))

    # ---- 22. kernels --------------------------------------------------------
    flops, nbytes = k1_flops_bytes(cfg, len(w4), epochs)
    bound_ms = 1e3 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_S)
    width = cfg.seq_len * cfg.dim + cfg.cond_dim + 1
    k3_flops, k3_bytes = scale_flops_bytes(cfg, SCALE_N, SCALE_EPOCHS, True, 2, width)
    k3_bound, k3_by = bound(k3_flops, k3_bytes, BF16_FLOPS)
    k4_flops, k4_bytes = scale_flops_bytes(cfg, SCALE_N, 1, False, 2, width)
    k4_bound, k4_by = bound(k4_flops, k4_bytes, BF16_FLOPS)
    scale_src = f"{PKG}/csrc/fused_scale.cu"
    k2_rows = [len(corpora[k]) for k in keys]
    k2_flops, k2_bytes = grid_flops_bytes(cfg, k2_rows, sum(k2_rows), DEPTH)
    k2_bound, k2_by = bound(k2_flops, k2_bytes, FP32_FLOPS)
    sw_flops, sw_bytes = grid_flops_bytes(cfg, [len(w4)] * SWEEP_SEEDS, len(w4), DEPTH)
    sw_bound, sw_by = bound(sw_flops, sw_bytes, FP32_FLOPS)
    # a run on one SM: the largest run alone at one SM's share; a cluster of
    # cs CTAs has cs SMs' share
    one_sm_ms = 1e3 * grid_flops_bytes(cfg, [max(k2_rows)], 0, DEPTH)[0] / (FP32_FLOPS / 132)
    abl_src = f"{PKG}/csrc/scale_ablation.cu"
    pf = p1_flops(cfg)
    width41 = width + cfg.latent_dim
    corpus_bytes = ABL_EPOCHS * SCALE_N * width41 * 2
    p1_rows = []
    for name, mode, line, p1_ops, extra_bytes, lib_note in (
            ("p1_stream", "stream", 182, ABL_EPOCHS * SCALE_N * width41, 0, None),
            ("p1_sol", "sol", 148, ABL_EPOCHS * SCALE_N * pf["sol"], 4 * (width41 + 128) * 128,
             "no single PyTorch call: a chain of 24 products"),
            ("p1_ablation_fwd", "fwd", 94, ABL_EPOCHS * SCALE_N * pf["fwd"],
             4 * cfg.n_params(), "no single PyTorch call: the CVAE's forward and loss"),
            ("p1_ablation_dx", "dx", 94, ABL_EPOCHS * SCALE_N * pf["dx"], 4 * cfg.n_params(),
             "no single PyTorch call: the forward and the gradient in x")):
        b_ms, b_by = bound(p1_ops, corpus_bytes + extra_bytes + 4 * 8 * ABL_EPOCHS,
                           FP32_FLOPS if mode == "stream" else BF16_FLOPS)
        p1_rows.append({
            "name": name, "route": "cuda", "source": abl_src,
            "replaces": f"scripts/scale_ablation.py:{line}",
            "launches": abl_launches[name], "cuda_launches": abl_cuda[mode],
            "max_abs_err": p1_res[mode]["max_abs_err"], "ms": p1_res[mode]["ms"],
            "plain_ms": p1_res[mode]["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": p1_res[mode].get("library_ms"),
            **({"library_note": lib_note} if lib_note else {}),
            **({"fp32_fma_bound_ms": 1e3 * p1_ops / FP32_FLOPS} if mode != "stream" else {}),
            "epochs": ABL_EPOCHS, "flops": p1_ops, "card": card})
    p2_bytes = P2_EPOCHS * SCALE_N * cfg.latent_dim * 2 + 32
    p2_bound, p2_by = bound(P2_EPOCHS * SCALE_N * cfg.latent_dim, p2_bytes, FP32_FLOPS)
    # the autodiff tier (bounds: the same products as the manual instances;
    # prng draws ε in the kernel, so no ε stream is read), dwT and P3
    k3a_flops, k3a_bytes = scale_flops_bytes(cfg, SCALE_N, SCALE_EPOCHS, True, 2, width, False)
    k3a32_flops, k3a32_bytes = scale_flops_bytes(cfg, SCALE_N, SCALE_EPOCHS, True, 4, width,
                                                 False)
    k4a_flops, k4a_bytes = scale_flops_bytes(cfg, SCALE_N, 1, False, 2, width, False)
    dwt_flops, dwt_bytes = scale_flops_bytes(cfg, SCALE_N, ABL_EPOCHS, True, 2, width)
    p3_bytes, p3_flops = 2 * 4 * cdy.SHAPE[0] * cdy.SHAPE[1], 2 * cdy.SHAPE[0] * cdy.SHAPE[1]
    auto_rows = []
    for name, route_src, line, n_l, err, ms, p_ms, (fl, nb, peak), extra in (
            ("k1_auto", "fused_trainer.cu", "ops/fused_trainer.py:326", k1a_launches, k1a_err,
             k1a_ms, k1a_plain_ms, (flops, nbytes, FP32_FLOPS),
             {"one_sm_bound_ms": bound_ms * 132, "cluster": k1a_cluster,
              "cluster_bound_ms": bound_ms * 132 / k1a_cluster, "phases_ms": k1a_split[1],
              "phases_epochs": SPLIT_EPOCHS,
              "ms_of": ENTRY_MS_OF, "vs_manual_3000_epochs_params_max_abs": k1a_vs_manual}),
            ("k3_auto_bf16", "fused_scale_auto.cu", "ops/fused_scale.py:191",
             cli_runs["f32_acts"]["launches"], auto_bench["f32_acts"]["max_abs_err"],
             auto_bench["f32_acts"]["ms"], auto_bench["f32_acts"]["plain_ms"],
             (k3a_flops, k3a_bytes, BF16_FLOPS),
             {"mode": "f32_acts", "noise": "prng", "fp32_fma_bound_ms": 1e3 * k3a_flops / FP32_FLOPS,
              "cli_ms": cli_runs["f32_acts"]["ms"]}),
            ("k3_auto_f32", "fused_scale_auto.cu", "ops/fused_scale.py:191",
             cli_runs["float32"]["launches"], auto_bench["float32"]["max_abs_err"],
             auto_bench["float32"]["ms"], auto_bench["float32"]["plain_ms"],
             (k3a32_flops, k3a32_bytes, FP32_FLOPS),
             {"mode": "float32", "noise": "prng", "cli_ms": cli_runs["float32"]["ms"]}),
            ("k3_bf16_chain", "fused_scale_auto.cu", "ops/fused_scale.py:191",
             cli_runs["bf16_chain"]["launches"], auto_bench["bf16_chain"]["max_abs_err"],
             auto_bench["bf16_chain"]["ms"], auto_bench["bf16_chain"]["plain_ms"],
             (k3a_flops, k3a_bytes, BF16_FLOPS),
             {"mode": "bf16_chain", "noise": "prng",
              "fp32_fma_bound_ms": 1e3 * k3a_flops / FP32_FLOPS,
              "entry_ms": cli_runs["bf16_chain"]["ms"]}),
            ("k4_auto", "fused_scale_auto.cu", "ops/fused_scale.py:500", k4a_launches,
             k4a_bench["grad_max_abs"], k4a_ms, k4a_plain_ms, (k4a_flops, k4a_bytes, BF16_FLOPS),
             {"mode": "f32_acts", "max_rel_err": k4a_bench["grad_max_rel_to_array_max"],
              "one_tile_max_ulps": k4a_tile["max_ulps"], "dp_epochs": AUTO_DP_EPOCHS}),
            ("k3_dwT", "fused_scale_knob.cu", "ops/fused_scale.py:256", abl_launches["k3_dwT"],
             dwt_bench["params_max_abs"], dwt_ms, dwt_plain_ms,
             (dwt_flops, dwt_bytes, BF16_FLOPS),
             {"epochs": ABL_EPOCHS, "max_abs_err_epochs": ABL_PLAIN_EPOCHS}),
            ("p3", "cache_decoy.cu", "scripts/cache_probe.py:102", p3_launches,
             p3_check["max_abs_err"], p3_ms, p3_plain_ms, (p3_flops, p3_bytes, FP32_FLOPS),
             {"library_call": "torch.add(ones, x, alpha=2.0)", "bytes": p3_bytes,
              **{k: p3_timing[k] for k in ("device_ms", "library_device_ms", "spread",
                                           "host_split_us")}})):
        b_ms, b_by = bound(fl, nb, peak)
        replaces = (f"defensive_model_vae_tpu/{line}" if line.startswith("ops/") else line)
        auto_rows.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{route_src}",
            "replaces": replaces, "launches": n_l, "max_abs_err": err, "ms": ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": p3_lib_ms if name == "p3" else None, **extra, "flops": fl,
            "card": card})
    emit({"kernels": [{
        "name": "k1_fused_trainer",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:326",
        "launches": launches,
        "max_abs_err": k1_err["max_abs_err"],
        "ms": kernel_ms,
        "ms_of": ENTRY_MS_OF,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES_S else "bytes",
        "library_ms": None,
        "one_sm_bound_ms": bound_ms * 132,
        "cluster": k1_cluster,
        "cluster_bound_ms": bound_ms * 132 / k1_cluster,
        "phases_ms": k1_split[1],
        "phases_epochs": SPLIT_EPOCHS,
        "flops": flops,
        "card": card,
    }, {
        "name": "k1_fused_trainer_seed_grid",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:326",
        "launches": seeds_launches,
        "clusters": SWEEP_SEEDS,
        # the 4-seed grid against its plain version, 50 epochs, explicit ε
        "max_abs_err": seeds_err["max_abs_err"],
        "ms": seeds_ms,
        "ms_of": ENTRY_MS_OF,
        "plain_ms": seeds_plain_ms,
        "bound_ms": sw_bound,
        "bound_by": sw_by,
        "library_ms": None,
        "one_sm_bound_ms": one_sm_ms,
        "cluster": seeds_cluster,
        "cluster_bound_ms": one_sm_ms / seeds_cluster,
        "phases_ms": seeds_split[1],
        "phases_epochs": SPLIT_EPOCHS,
        "flops": sw_flops,
        "card": card,
    }, {
        "name": "k2_fused_train_multi",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:454",
        "launches": k2_launches,
        "clusters": len(keys),
        # the four corpora against the plain version, 50 epochs, explicit ε
        "max_abs_err": k2_err["max_abs_err"],
        "ms": k2_ms,
        "ms_of": ENTRY_MS_OF,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
        "one_sm_bound_ms": one_sm_ms,
        "cluster": k2_cluster,
        "cluster_bound_ms": one_sm_ms / k2_cluster,
        "phases_ms": k2_split[1],
        "phases_epochs": SPLIT_EPOCHS,
        "flops": k2_flops,
        "card": card,
    }, {
        "name": "k3_fused_scale",
        "route": "cuda",
        "source": scale_src,
        "replaces": "defensive_model_vae_tpu/ops/fused_scale.py:191",
        "launches": k3_launches,
        # at the bench shape, over its first PROBE_EPOCHS epochs
        "max_abs_err": k3_bench["params_max_abs"],
        "max_abs_err_epochs": PROBE_EPOCHS,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
        "fp32_fma_bound_ms": 1e3 * k3_flops / FP32_FLOPS,
        "f32_ms": k3_f32_ms,
        # the tensor-core instructions of its library's SASS (every
        # instance's: manual, knobs, autodiff)
        "sass_mma": sass_mma["fused_scale"],
        "ablation_calls": abl_launches["_fused_scale_call"],
        "flops": k3_flops,
        "card": card,
    }, {
        "name": "k4_grad_epoch",
        "route": "cuda",
        "source": scale_src,
        "replaces": "defensive_model_vae_tpu/ops/fused_scale.py:500",
        "launches": k4_launches,
        # at the bench shape; its gradients are of order 1e14 at the
        # initial params, so also the error as a fraction of each array's max
        "max_abs_err": k4_bench["grad_max_abs"],
        "max_rel_err": k4_bench["grad_max_rel_to_array_max"],
        "sass_mma": sass_mma["fused_scale"],
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
        "fp32_fma_bound_ms": 1e3 * k4_flops / FP32_FLOPS,
        "flops": k4_flops,
        "card": card,
    }] + p1_rows + [{
        "name": "p2_stream_sum",
        "route": "cuda",
        "source": abl_src,
        "replaces": "scripts/noise_consumer_probe.py:78",
        "launches": abl_launches["p2_stream_sum"],
        "cuda_launches": abl_cuda["p2"],
        "max_abs_err": abl_err["p2"],
        "ms": p2_ms,
        "plain_ms": p2_plain_ms,
        "bound_ms": p2_bound,
        "bound_by": p2_by,
        "library_ms": p2_lib_ms,
        "library_call": "torch.sum(eps, dtype=torch.float32)",
        "device_ms": p2_timing["device_ms"],
        "library_device_ms": p2_timing["library_device_ms"],
        "bound_share": p2_bound / p2_timing["device_ms"],
        "spread": p2_timing["spread"],
        "bytes": p2_bytes,
        "card": card,
    }] + auto_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
