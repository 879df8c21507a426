#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its name and seconds, each under
a watchdog (``faulthandler.dump_traceback_later``) that turns a hang into a
traceback and a non-zero exit:

1. ``device``      torch, CUDA, the card, ``nvidia-smi``, ``nvcc``, triton;
2. ``build``       ``nvcc`` builds every kernel of the port, all at once
                   (each object's nvcc seconds printed); the tensor-core
                   instructions of K3/K4's and P1-sol's libraries counted
                   (``cuobjdump``; P1-sol must hold HGMMA);
                   then the cache probe's decoy: P3 compiled in round B's
                   directory, launched and held against x * 2 + 1 bit for
                   bit; and its rounds A, A2 and B start, two nvccs at a
                   time (``scripts/cache_probe.py``);
3. ``cache_probe`` (printed after ``scoreboard``: the rounds finish beside
                   the phases in between, two at a time, and P3's
                   host timing wants a quiet host) the probe's verdicts for
                   each object; P3
                   timed in turns with ``torch.add`` through its wrapper and
                   on the device alone (calls replayed from a CUDA graph,
                   every output bit for bit x * 2 + 1); the host split of a
                   call;
4. ``k1_vs_plain`` kernel K1 against its plain torch version on the card
                   (explicit ε, sce2 B=16 and sce4 B=134, 1 and 50 epochs);
5. ``train``       the main path: ``fused_train`` on sce4 at full width
                   (134 windows, H=128, 3000 epochs) in one K1 launch (one
                   thread-block cluster), its time against the plain
                   version's, a checkpoint round trip; one more run of 300
                   epochs with the phase timer for K1's phase split;
6. ``sample``      one trajectory per sce4 start point, with re-draws;
7. ``track``       the samples tracked by the batched MPC (its step one
                   captured CUDA graph a batch size of 3 x (form, LU,
                   update) kernels, replayed a step; the LU and step
                   kernels' launches on this path counted), and the SLSQP
                   golden windows held to the bands of tests/test_mpc.py;
                   the captured tracker bit for bit the same kernels
                   launched without a capture at 2, 16, 38 and 134 rows
                   and 64 steps, a second call replaying without a
                   capture; the step kernels (``csrc/mpc_step.cu``) bit
                   for bit their plain mirror on one LM iteration and
                   within tolerance of the torch step over 64 steps, their
                   device time a step at 16 and 134 rows beside its bound
                   and the torch step's; the LU kernel
                   (``csrc/lu_solve.cu``): its register form bit for bit
                   its shared-memory form on the tracker's, the sweep's,
                   tie and out-of-range systems
                   (``scripts/lu_checks.py``), against
                   ``torch.linalg.solve_ex`` on the tracker's LM systems
                   at 1-134 rows, timed in turns with it and with the
                   shared-memory form at the serve batch;
8. ``data``        the native CSV loader built (``data/csv_io.py``, g++),
                   the four committed corpora written as CARLA episode CSVs
                   (``scripts/episodes.py``) and read back by the port's
                   ``build_dataset``, each equal to its fixture byte for
                   byte; the loader's rows parsed per second;
9. ``pipeline``    ``pipeline.run_scenario`` on sce2 from those episodes with
                   the committed checkpoint: one finite trace per valid
                   sample under unique names, each bit for bit
                   ``generate_and_track_from_starts`` on the starts and
                   initial states ``get_start_conditions`` read, a
                   ``validation_sce2.json`` of finite metrics over the 16
                   human tracks; the stage split.  No kernel of the port is
                   on this path;
10. ``dnda``       SUT risk scoring (``dnda/``, ``sut/``,
                   ``metrics/surrogate.py``; plain torch and host numpy, no
                   kernel of the port): 256 synthetic frames of the four
                   scenarios (``scripts/dnda_sweep.py``) swept on the card in
                   float32 and float64 SAT, index for index the numpy
                   oracle, DA/RL bit for bit the host's; the pinned frame of
                   tests/test_dnda.py:231; the sweep tiled to 3,072 frames
                   timed (wall, CUDA events, host padding, peak memory)
                   beside the numpy sweep; the SUT chain: eight committed
                   traces written back into the data phase's episodes,
                   scored by ``score_directory`` on the card and on the host
                   (rows equal), TTC, PET and JERK on each;
11. ``k3_vs_plain`` kernels K3 and K4 against their plain torch versions on
                   the card (f32 and bf16, packed, hbm and prng noise, ragged
                   corpora, blocks of one 32-row step and of several; the
                   bf16 rows within twice the plain version's own order
                   spread), and K4 on an order-free case
                   (``scripts/k3_order_noise.py``) bit for bit in float32 and
                   bf16, a plain version without one step unequal;
12. ``train_scale`` the production-scale path at the bench shape:
                   ``fused_train_scale`` on 131,072 windows, 200 epochs, tile
                   2048, bf16, hbm noise, in one K3 call; K3's time against
                   the plain version's, and K3 held against it over the
                   first 10 epochs; a float32 run; a per-epoch
                   ``fused_train_scale_dp`` run through K4; K4 timed and held
                   against its plain version; a checkpoint round trip;
13. ``k2_vs_plain`` kernel K2 against its plain (padded and masked) torch
                   version on the card: the four fixture corpora, explicit ε,
                   1 and 50 epochs; and K1 on a grid of 4 seeds against K1's
                   plain version once per seed;
14. ``multi``      the path that trains every scenario's model:
                   ``fused_train_multi`` on the four corpora at 3000 epochs
                   in one K2 launch, each scenario converging (last <
                   first/5); K2 timed against its plain version; at 300
                   epochs each scenario held against ``fused_train`` with
                   seed + i; each model sampled at every start, every start
                   tracked with its scenario's tracker, controls within
                   bounds;
15. ``track_multi`` ``generate_and_track_multi_from_starts`` with 4
                   generation seeds on the sce2 model, row by row against
                   per-seed ``generate_and_track_from_starts``;
16. ``seeds``      the seed sweep: ``fused_train_seeds`` on sce4, 32 seeds ×
                   3000 epochs in one launch of K1 on 32 clusters, every seed
                   converging; timed against the plain version; at 300
                   epochs 4 seeds bit for bit against ``fused_train``;
17. ``ablation_vs_plain`` the K3 ablation's kernels against their plain
                   versions on an 8,448-row bf16 corpus with packed ε (tiles
                   of 352: two 32-row steps a block, one chunk straddling the
                   last tile): K3 under each of its seven ``_ablate`` knobs at
                   1 and 3 epochs (dwT among them), K3 with ``_ablate=()`` and K4 bit for
                   bit their reference digests (``scripts/k3_digest.py``), P1's
                   stream, fwd and dx kernels, dx's limit held below plain
                   versions with one deliberate error; P1-sol bit for bit
                   on an order-free case whose every sum is exact (the
                   kernel's last tile ragged; both deliberate errors
                   missing it) and on the corpus within
                   its plain version's own order spread (``ORDER_TOL``, the
                   live spread printed beside it); P2
                   at the full 200 × 131,072 × 8 bf16 stream, four calls
                   (the second on the stream negated) bit for bit alike,
                   its limit held below plain versions that drop a batch
                   or a block;
18. ``ablation``   the ported ``scripts/scale_ablation.py`` at the bench
                   width (131,072 windows, tile 2048, bf16), 20 epochs, 1
                   warm + 1 timed rep of every variant, its breakdown line;
                   the ported P2 probe's two variants at full shape; every
                   ablation kernel launched (the CUDA launches as the C
                   entries count them; P2 one a call); P2 timed in turns
                   with ``torch.sum`` through its wrapper and on the device
                   alone; P1 held against its plain versions
                   there, as in phase 17, and timed; P1-stream (one launch
                   for all epochs) timed in turns with ``torch.sum`` through
                   its wrapper and on the device alone; P1-sol timed in turns
                   with the same chain as 24 cuBLAS bf16 products; K3 under dwT held
                   against its plain version over the first 2 epochs;
19. ``train_auto`` K1's autodiff instance on its main path:
                   ``fused_train(backward="auto")`` on sce4 at 3000 epochs,
                   timed, its gap to the manual run printed;
20. ``auto_vs_plain`` the autodiff instances against their plain versions
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
21. ``train_scale_auto`` ``train --fused-scale --backward auto`` at the
                   bench shape, prng, bf16 and float32, and a bf16_chain
                   run; each instance's launch timed alone and held against
                   its plain version over its first epochs; the per-epoch
                   tier through K4-auto;
22. ``scan_bf16`` the scan trainer's bf16 chain, ``train_multi_scenario``
                   on the four fixtures and ``train_conditioned`` with one
                   extra condition column, 100 epochs each, every final
                   loss within its band of the float32 run's;
23. ``conv``       BASELINE config 3, the temporal-conv VAE
                   (``models/conv_cvae.py``, ``train_conv``; plain torch,
                   no kernel of the port) at the shapes of
                   ``bench.py::bench_conv_long``: 256 random-walk windows
                   × 50 × 2, 500 epochs, timed (wall, CUDA events, windows
                   a second), converging; 20 epochs on the card against the
                   same on the CPU (same init and noise), and twice on the
                   card bit for bit (cuDNN deterministic); sampling from 256
                   starts away from the origin, each first point within 3 m;
                   a Conv1D checkpoint back as a ``ConvCVAEConfig``;
24. ``edges``      the committed sce1 exported to ``.pth`` and imported
                   back bit for bit, scenario and offset mode read from the
                   file name; the scan trainer resumed through
                   ``opt_state.npz`` bit for bit one long run; the horizon
                   sweep on a sce1 window; the linear MPC's sine road on
                   the card (JAX's bounds, and against the CPU);
                   ``cli.py doctor`` with exit code 0;
25. ``k1_digest``  ``scripts/k1_digest.py``: K1, K1-auto, K2 and the seed
                   grid (50 and 3000 epochs) bit for bit the one-block
                   build's digests at the picked cluster size, and K1's
                   50-epoch case at each forced size 1, 2, 4, 8 and 16;
26. ``serve``      the serving path (``serving.serve_checkpoint``): the
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
                   share; the step graph captured by the warm-up and none
                   by the requests; the request's launches of the step
                   and LU kernels (3 a step each); the same program with
                   its step kernels launched without a capture, bit for
                   bit the served states, and its wall;
27. ``parallel``   the data-parallel tier (``parallel/``) over
                   ``torch.distributed``: a NCCL world of one on the card
                   (``fused_train_scale_dp(mesh=create_mesh())`` at the bench
                   width and tile in bf16, cut to 32,768 rows × 20 epochs,
                   and ``train(mesh=...)`` 20 epochs of sce4, each bit for
                   bit mesh=None; K4's dp launches counted), and a gloo
                   world of two spawned ranks sharing the card (the dp tier
                   with explicit ε, ``track_batch`` on 16 sce4 starts, the
                   serve program at batch 16, the sweep on 64 synthetic
                   frames), each held to one device, its ranks started
                   before ``edges`` so that their start-up runs beside the
                   phases up to this one; which collectives gloo takes on
                   CUDA tensors; the dp wall time, K4's ms a launch a rank
                   and the all-reduce's ms an epoch (the run's own CUDA
                   events);
28. ``drivers``    the port's research drivers (``scripts/``) at full width
                   and cut depth (DRV_*): first K2's two options on the
                   card, ``use_mask=False`` on the four corpora padded to 134
                   rows against the plain version (1 and 50 epochs) and
                   ``_metrics="static"`` bit for bit the full store; then
                   ``grid_probe`` (32 seeds of sce1, its five variants and
                   checks), ``run_baseline_configs`` (configs 1-4 finite and
                   descending, 5 skipped without the episode CSVs),
                   ``serve_latency`` (batch 1, the tail under concurrent
                   clients with no error, a batch-16 throughput),
                   ``hot_probe`` (K3 at the bench width: the hbm stream's
                   generation against its streaming), ``robustness_row``,
                   and ``mint_provenance_probe`` (the build cache's keys
                   from copies of the package; P3 built at two paths, in a
                   thread beside the others); each driver's launches counted;
30. ``scoreboard`` (before ``cache_probe`` and ``kernels``) the scoreboard
                   and the last four research drivers at full width and cut
                   depth (SB_*), on the data phase's episode trees and the
                   dnda phase's SUT episodes, every output in a temporary
                   directory: ``pipeline.reproduce_scoreboard`` over the four
                   scenarios at the seeds their committed artifacts record
                   (reports finite or null, boards of the published-best
                   cells); again through ``cli.py reproduce --check`` in
                   process (exit 0: the card path is deterministic at a
                   fixed seed), and on a copy with one sce2 metric moved by
                   1e-3 (exit 1, that metric alone failed); the boards'
                   beats printed as the written trees', not the human data's;
                   ``seed_sweep`` (its ranking ``rank_candidates`` on its own
                   rows); ``multiseed_validate`` chunked, stopped after its
                   first chunk and resumed (bit for bit the uninterrupted
                   run), and its gap to one tracking call; ``stage_timings``
                   (K2's warm and timed 4 x 300 launches counted);
                   ``dnda_drift_probe`` with ``staged_sweep``'s maxima equal
                   to ``score_directory``'s rows;
29. ``kernels``    one line listing every ported kernel with its launches on
                   its main path, its error, times and bound (P2 and P3 also
                   their device times, their library call's both ways, and
                   the spread of each; the K1 family its cluster size, its
                   bound over the cluster's SMs and its phase split; K4 its
                   launches on the parallel phase's dp tier; K1, K2, K3 and
                   dwT their launches in the drivers phase, K2 those under
                   each option and grid_probe's µs an epoch and seed, and
                   its launches in the scoreboard phase).

Every phase line that ran the tracker carries ``tracker_graph``: the step
graphs captured and the steps replayed in that phase.  Before the
``kernels`` line, the check's own seconds (``check_s``).  The
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the port beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import faulthandler
import json
import os
import pathlib
import re
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

# the track phase's checks of the tracker (control/mpc.py): the captured
# step graph against the eager loop at TRACK_GRAPH_ROWS rows and
# TRACK_GRAPH_STEPS steps bit for bit (the same kernels on the same shapes:
# no tolerance; the serve phase holds the serve batch at its 512 steps), a
# second call at each shape replaying without a capture; the LU kernel
# (csrc/lu_solve.cu) against its plain version, torch.linalg.solve_ex, on the LM systems of the
# tracker's first step at LU_ROWS rows.  Both are float32 LU with partial
# pivoting whose sums run in other orders, so neither gives the other's
# bits; each solve is held to what such an LU guarantees: its normwise
# backward error |Hx - g| / (|H| |x| + |g|) (infinity norms, float64) at
# most n u (u = 2^-24, growth factor 1; the kernel's measured 1e-9-2e-8 at
# n = 40 on the CPU, against 2.4e-6), and the kernel's gap to the plain
# version at most the 2 kappa(H) n u |x| that two such solves can part by
# (kappa(H) the float64 condition number).  A wrong pivot or a row left
# out moves the backward error to order 1.  Its register form (the main
# path's, n <= 64) bit for bit its shared-memory form (the first, form="smem")
# and the host's emulation of their arithmetic on the cases of
# scripts/lu_checks.py (the tracker's systems at 1-134 rows, the sweep's
# orders 10, 20, 60, a tie case at each order, the wrong pivot rule's
# emulation unequal there, and a case out of the fast divisions' range).
# The kernel timed at the serve batch over LU_TIMED_CALLS calls a block,
# in turns with solve_ex (its library call) and with the shared-memory
# form.
TRACK_GRAPH_ROWS, TRACK_GRAPH_STEPS = (2, 16, 38, 134), 64
# the tracker's step kernels (csrc/mpc_step.cu): the captured graph bit for
# bit the same kernels launched without a capture (above); the kernels bit
# for bit their plain mirror (ops/mpc_step.py) on one LM iteration at each
# batch of TRACK_GRAPH_ROWS; the kernels' simulation against the torch step
# (_simulate_eager, TF32 off), which sums in other orders, at
# TRACK_GRAPH_ROWS x TRACK_GRAPH_STEPS: states within MPC_STATE_TOL (the
# tracker's whole-simulation tolerance, tests/test_torch_mpc.py) and each
# row's mean control gap within MPC_CONTROL_MEAN_TOL
# (tests/test_torch_mpc_graph_card.py).  Timed at MPC_TIMED_ROWS x
# SERVE_STEPS: a step's CUDA-event time in the replay loop, each kernel's
# device time a step (torch.profiler over the whole run), the plain torch
# step's wall over MPC_PLAIN_STEPS steps
MPC_STATE_TOL, MPC_CONTROL_MEAN_TOL = 1e-3, 1e-4
MPC_TIMED_ROWS, MPC_PLAIN_STEPS = (16, 134), 16
LU_ROWS, LU_TIMED_CALLS = (1, 16, 38, 134), 50
LU_U = 2.0 ** -24

# the dnda phase: 256 distinct synthetic SUT frames (the four scenarios'
# baselines, 0-6 vehicles; scripts/dnda_sweep.py) held index for index
# against the numpy oracle, then tiled to 3,072 frames (the SUT corpus's
# 3,014 scored frames rounded up to 12 chunks of 256) and timed; the SUT
# chain on the first two committed traces of each scenario
DNDA_FRAMES, DNDA_TILE, DNDA_SEED, DNDA_REPS = 256, 3072, 0, 2
DNDA_TRACES_EACH = 2
# the frame pinned from live runs of the reference (tests/test_dnda.py:231)
DNDA_PINNED = {"da": 42.6688, "da_tol": 1e-3, "rl": 0.767949, "rl_tol": 1e-5}

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
# The bf16 rows of one and twenty epochs held K3 to the plain version's own
# summation order: with only the order of the step products' sums moved (the
# hidden units permuted), the plain version parts from itself by more than
# they allowed (scripts/k3_order_noise.py, 32 permutations on the CPU: after
# one epoch a few elements step the other way, 2.0e-3 at most, 1.22e-4 of an
# array, loss rows 2.76e-5 apart; after twenty 1.33e-2, 1.56e-2 and
# 2.29e-3).  So those two rows are twice that spread, and beside them K4
# and one epoch of K3 (its gradients, then Adam's first step) are held bit
# for bit on an order-free case (the k3_vs_plain phase), as P1-sol is.
# The pair still sees a 32-row step left out of 9,000 (the card tests'
# deliberate error: 7.8e-3 of an array over a tenth of a step, loss rows
# 3.9e-3 apart, and the order-free case unequal).  The ten-epoch row (three
# epochs of the ablation's corpus: 4.30e-3, 4.9e-4, 1.23e-4 apart) holds.
STEP_TENTH = 1e-4
K3_TOL = {(None, 1): {"params_abs": 1e-5, "params_frac": 0.0, "metrics_rel": 1e-5},
          (None, 5): {"params_abs": 1e-4, "params_frac": 0.0, "metrics_rel": 1e-4},
          (None, 20): {"params_abs": 1e-4, "params_frac": 0.0, "metrics_rel": 1e-4},
          ("bfloat16", 1): {"params_abs": 4.0e-3, "params_frac": 2.44e-4,
                            "metrics_rel": 5.52e-5},
          ("bfloat16", 10): {"params_abs": 5e-3, "params_frac": 0.05, "metrics_rel": 1e-3},
          ("bfloat16", 20): {"params_abs": 2.67e-2, "params_frac": 3.125e-2,
                             "metrics_rel": 4.58e-3}}
# three epochs under an ablation knob (ablation_vs_plain), or two at the
# bench width (ablation): the ten-epoch row's numbers, since from the
# second epoch on a few elements can take steps the other way, as above
K3_TOL[("bfloat16", 3)] = K3_TOL[("bfloat16", 2)] = K3_TOL[("bfloat16", 10)]
# float32 over three epochs (the autodiff instances): the five-epoch row's
# numbers hold for fewer epochs
K3_TOL[(None, 3)] = K3_TOL[(None, 5)]
# the loss rows of noacc and of K3's autodiff instances in bf16: their own
# summation-order spreads are not measured, so they keep the limits they
# were held to before the one-epoch row above was set to K3's spread
K3_BF16_METRICS_REL = {1: 1e-5, 3: 1e-3}
# noacc: Adam's step reads one tile's gradient sum (352 rows in
# ablation_vs_plain), in which more elements sit at bf16 rounding level than
# in the whole corpus's, and such an element can step the other way each
# epoch: its params are held to that travel (2·E·lr) and to the share of
# elements over a tenth of a step (5%), its gradient itself to K4's rule
NOACC_TOL = {ep: {"params_abs": 2 * ep * 1e-3 + 1e-5, "params_frac": 0.05,
                  "metrics_rel": K3_BF16_METRICS_REL[ep]} for ep in (1, 3)}
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


# the K3 ablation (phases 17 and 18).  P1 and P2 against their plain
# versions: each sum within a fraction of the sum of the absolute values of
# its terms — float32 sums in another order (stream: 1e-5); fwd's loss
# components rtol 1e-5, as K3's one-epoch rows.  dx's sum passes through
# chains of products whose float32 sums, taken in another order, can round
# an intermediate to the neighbouring bf16 value; its limit lies between
# the sound runs' gaps and those of plain versions with one deliberate
# error each (p1_wrong_sums), which both phases print and hold above it.
ABL_N, ABL_TILE = 8448, 352
ABL_EPOCHS, ABL_REPS, ABL_PLAIN_EPOCHS = 20, 2, 2
P1_TOL = {"stream": 1e-5, "dx": 1e-6, "fwd_rel": 1e-5}
# P1-sol is held by two checks (scripts/sol_checks.py): an order-free case
# bit for bit, and the corpus within twice its plain version's own spread
# under permuted summation orders (ORDER_TOL, the live spread beside it).
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
                         "metrics_rel": K3_BF16_METRICS_REL[ep]} for ep in (1, 3)}


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
# convergence"), finite and descending; at a third of that test's 300
# epochs to keep the check under 300 s (no kernel runs in this phase)
SCAN_EPOCHS, SCAN_BF16_BAND = 100, 2.0
# the multi phase samples every start of each K2 model and tracks all of
# them (38-134 a model) with its scenario's tracker
# the conv phase: BASELINE config 3 at the shapes of bench.py::bench_conv_long
# (:928): 256 random-walk windows of 50 points × 2, step 5 m, seed 0, the
# default ConvCVAEConfig (channels 32/64/128, kernel 5, H 128, Z 8), 500
# epochs; converged when the last loss is below a third of the first (JAX
# tests/test_extras.py:241).  The card against the CPU over CONV_CHECK_EPOCHS
# on the same init and noise (TF32 off; one epoch's gradients are as close
# to float64 on the card as on the CPU, 8.8e-7 against 1.0e-6 of each
# array's max): over the first ten epochs the loss rows to a relative 1e-5
# of each row's largest value, summation order only (measured ≤ 3.1e-7, as
# K1_TOL's one-epoch row); over all twenty to 3e-4, because this training
# passes a point (epoch 15) where summation order is chaotic: there the
# CPU's own loss rows, with the initial params one ulp apart, move 3.0-6.6e-5
# (printed beside the gap each run: cpu_one_ulp_rel).  train_conv holds cuDNN
# to its deterministic algorithms, so the card gives the same bits run to
# run (checked: two card runs bit for bit) and the same gap every run,
# 1.628e-4 (PR 16, NVIDIA H100 80GB HBM3, 700 W; 1.6e-4 to 1.66e-4 before,
# run to run): above twice the CPU's one-ulp spread, so the limit stops at
# 3e-4, under twice that gap (it was 1e-3 while the card moved run to run).
# The params to 1e-2, ten of Adam's steps (lr 1e-3) the other way: an
# element whose gradient sits at the rounding noise of the two orders can
# step the other way each epoch.  Sampling as JAX's
# test_conv_train_sample_consistency_nonorigin (:279): the windows moved to
# 256 starts away from the origin, trained CONV_SAMPLE_EPOCHS (a third of
# that test's 300, to keep the check under 300 s: the first points sit
# within 0.15 m of their starts from 100 epochs on, on the CPU), one sample
# each from its start; every first point within 3 m of its start.
CONV_N, CONV_SEQ, CONV_STEP, CONV_EPOCHS = 256, 50, 5.0, 500
CONV_CHECK_EPOCHS, CONV_SAMPLE_EPOCHS = 20, 100
CONV_TOL = {"first_epochs": 10, "first_rel": 1e-5, "metrics_rel": 3e-4,
            "params_abs": 1e-2}
CONV_STARTS_AT, CONV_STARTS_SPREAD, CONV_START_M = (500.0, -300.0), 100.0, 3.0
# the edges phase: the optimizer-state round trip (the scan trainer on sce4,
# two halves of EDGE_OPT_EPOCHS through opt_state.npz against one run, bit for
# bit); the horizon sweep on sce1's window 1 as JAX tests/test_mpc.py:169
# (dt 0.05, mean error under 5 m); the linear MPC's sine road as :197 (after
# 40 steps within 0.2 m of the road, the end speed over 1.5 m/s, the inputs
# in their bounds), and its states against the CPU's to 1e-3 (float32
# rounding of the card's sin, cos and atan2 compounded over the closed loop)
EDGE_OPT_EPOCHS = 20
EDGE_SWEEP = {"combos": ((10, 5), (20, 10)), "dt": 0.05, "mean_m": 5.0}
EDGE_SINE = {"steps": 120, "settle": 40, "road_m": 0.2, "end_speed": 1.5,
             "card_vs_cpu": 1e-3}
# the parallel phase (the data-parallel tier over torch.distributed).  A NCCL
# world of one on the card: the dp tier at the bench width and tile (bf16,
# hbm noise) cut to PAR_DP_N rows × PAR_DP_EPOCHS epochs so the phase fits
# its budget (the train_scale phase runs the full 131,072 × 200 through the
# same K4 launches), and the scan trainer PAR_TRAIN_EPOCHS epochs on sce4,
# each bit for bit its mesh=None run (a world of one reduces nothing).  A
# gloo world of two ranks sharing the card: the dp tier with explicit ε
# (PAR_GLOO_N rows of the scale corpus, float32, tile 2048, two tiles a
# rank), track_batch on 16 sce4 starts (PAR_MPC, PAR_FIRST_START), the
# serve program on them at batch 16 and PAR_SERVE_STEPS steps, the sweep on PAR_SWEEP_FRAMES synthetic
# frames; the dp tier held to its one-device run at the CPU tests'
# tolerances, the sweep index for index.  The tracker's and the serve
# program's rows are held bit for bit to the one-device program on the same
# block of rows, and within SERVE_HOST_TRACK_TOL (the tracker's
# whole-simulation tolerance) to the one-device program on all 16 rows: on
# the card cuBLAS and cuSOLVER pick their kernels by the batch's shape, so a
# block of 8 rows rounds otherwise than 16 (PR 16, NVIDIA H100 80GB HBM3,
# 700 W: states 6.7e-5 and controls 5.5e-4 apart after 64 steps; on the
# CPU the two agree to 1e-7).  Its times are two ranks sharing one card
# over gloo, not a multi-card figure.  The gloo world is started before the
# edges phase (main): its ranks' start-up (6.5-10.7 s of importing torch and
# joining the group on the card machine, more on a slow host) runs beside
# edges, k1_digest and serve (20-25 s), so PAR_BUDGET_S holds the phase's
# own work alone (PR 16, NVIDIA H100 80GB HBM3, 700 W: 5.3-7.1 s with this
# process warm, 11.2-14.1 s cold; when the phase started the ranks itself,
# 11.8-37.6 s).
PAR_DP_N, PAR_DP_EPOCHS, PAR_TRAIN_EPOCHS = 32768, 20, 20
PAR_GLOO_N, PAR_GLOO_EPOCHS, PAR_SERVE_STEPS, PAR_SWEEP_FRAMES = 8192, 3, 64, 64
PAR_TOL = {"params_abs": 1e-5, "hist_rtol": 1e-4, "hist_atol": 1e-5, "states_abs": 1e-5}
# the tracker at tests/test_parallel.py:108's configuration, not sce4's
# (P 30, M 20, dt 0.02: 5.5 s a run on a rank over the first 16 starts)
PAR_MPC = {"prediction_horizon": 10, "control_horizon": 5, "dt": 0.05}
# the 16 sce4 starts after the first (whose window alone spans 16.6 s; the
# others 5.0-5.4 s): 128 tracker steps, not 384
PAR_FIRST_START = 1
PAR_WORLD_S = 60.0
PAR_BUDGET_S = 20
PAR_GLOO_LABEL = "two gloo ranks sharing one card (not a multi-card figure)"
# the drivers phase: the research drivers of the port's scripts/ at full
# width (CVAEConfig(), the bench width), each at a cut depth (ROADMAP Queue 3's
# table of cuts): grid_probe's 32 seeds of sce1 at DRV_GRID_EPOCHS (the
# script's 3000) and one timed rep (4); run_baseline_configs at
# DRV_BASE_EPOCHS (3000) and config 3 at DRV_CONV_EPOCHS (500); serve_latency
# at batch 1 and DRV_SERVE_STEPS steps (512), DRV_SERVE_REPS reps (7), a
# throughput batch of SERVE_BATCH and DRV_CONCURRENCY clients of
# DRV_LOAD_REQUESTS requests (8 of 25); hot_probe at 131,072 rows, tile 2048,
# DRV_HOT_EPOCHS epochs (200), one timed rep (4).  Before them, K2's two
# options held on the card: use_mask=False on the four corpora padded to 134
# rows as fused_train_multi pads them (explicit ε, which the padded rows draw
# too), against the plain version at GRID_TOL's 1 and 50 epochs; and
# _metrics="static" at 50 epochs bit for bit "full" in the params, its row 0
# "full"'s last row.  grid_probe holds the same at 32 seeds.  At 50 epochs
# the padded sce2 run (16 windows and 118 copies of its first, every one
# counted) is chaotic in the plain version alone: one float32 ulp on the
# initial params moves its total by 2.6e-2 of itself at epoch 46 (CPU),
# against GRID_TOL[50]'s 1e-3 (the ragged corpora of k2_vs_plain move by
# 2.3e-5 there).  So at 50 epochs the params are held to GRID_TOL[50] and
# the metrics' gap to the plain version's own one-ulp spread on the same
# corpus, measured beside it ("plain_one_ulp"); after one epoch, where no
# chaos has set in, the whole of GRID_TOL[1] holds.
DRV_GRID_EPOCHS, DRV_BASE_EPOCHS, DRV_CONV_EPOCHS, DRV_HOT_EPOCHS = 300, 100, 50, 20
DRV_SERVE_STEPS, DRV_SERVE_REPS, DRV_CONCURRENCY, DRV_LOAD_REQUESTS = 512, 7, 4, 2
# the phase's watchdog: its 23.3 s with serve_latency back at 512 steps and 7
# reps (NVIDIA H100 80GB HBM3, 700 W) times the 1.5x spread of host speed
# seen between calls, rounded up
DRV_BUDGET_S = 45
# the scoreboard phase: pipeline.reproduce_scoreboard over the four
# scenarios (never cut), then cli reproduce --check at the same seeds (the
# four again, never cut) and on sce2 with a metric moved, and the
# last four research drivers at full width (CVAEConfig()) and cut depth
# (ROADMAP Queue 3's table of cuts; JAX's script's value in brackets):
# seed_sweep on sce2 at SB_SWEEP_SEEDS train seeds (0:70) x SB_SWEEP_EPOCHS
# epochs (3000), selection seeds SB_SELECT_SEEDS (5,6,8), the top 1 on the
# band seeds SB_BAND_SEEDS (70 seeds); multiseed_validate on sce2 at
# SB_BAND_GENS (70 seeds, all four scenarios) in chunks of SB_CHUNK (the
# script's usage line's 10: two chunks, so the run can stop after the first);
# stage_timings on sce2 alone (all four), K2 whole at 4 x 300 epochs, the
# DNDA stage over the dnda phase's SUT episodes with host preparation
# inline (a pool of one a core); dnda_drift_probe at SB_DRIFT_REPS reps (4),
# inline.  Every output goes to a temporary directory, never results/.
SB_SWEEP_SEEDS, SB_SWEEP_EPOCHS, SB_SELECT_SEEDS, SB_BAND_SEEDS = "0:2", 300, "5", "0,1"
SB_BAND_GENS, SB_CHUNK, SB_K2_EPOCHS, SB_DRIFT_REPS = ",".join(map(str, range(20))), 10, 300, 1
# the committed artifact's metric that the check must catch when moved
SB_PERTURB = ("sce2", "velocity_js_divergence", 1e-3)
# The phase ran 19 tracker runs of 1-10 s each while the tracker ran eagerly
# (114.3 s alone and 146.4-184.6 s in the whole check, NVIDIA H100 80GB
# HBM3, 700 W); with the step captured it took 26.0-35.6 s in the check
# with the multiseed chunks back at 10 (the reproduction 3.5 s, its check
# 3.2-3.4, seed_sweep's training 9.5-10.3, on the faster hosts).  The
# watchdog is the worst of those runs times the spread of host speed seen
# between calls (1.5x), rounded up
SB_BUDGET_S = 55
# the cache probe: each round's nvccs, and the phase that waits for them.
# Its three rounds (nine objects, three of them K1's, the build's longest)
# start once the build is done: beside it they held it up (the build 134.3 s
# with them, 64.5-87.8 s alone, on the card machine's 8 cores).
# They run beside the phases that follow, cache_probe.SLOTS at a time, so
# that the phases' host-clock times (the plain versions', the walls) keep
# the other cores to themselves (one object's nvcc is one process of one
# thread at a time).
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


def sol_library_chain(torch, packed, w_in, w_ch, n_chain, epochs):
    """P1-sol's function as cuBLAS products on bf16 tensors, ``epochs``
    times: the entry product and n_chain - 1 products with bf16 outputs (the
    chain's rounding), the last with a float32 output, its sum (float32) per
    epoch.  The yardstick of the ``kernels`` line; the port never calls it."""
    out = []
    for _ in range(epochs):
        h = packed @ w_in
        for _ in range(n_chain - 1):
            h = h @ w_ch
        out.append(torch.mm(h, w_ch, out_dtype=torch.float32).sum())
    return out


def sol_library_turns(torch, sa, packed, w_in, w_ch, n_chain):
    """P1-sol at ABL_EPOCHS in turns with sol_library_chain (CUDA events,
    TURN_ROUNDS rounds of kernel, library, library, kernel; bf16 reductions
    in full precision) → {"turns_ms", "library_ms", "spread"}."""
    mm = torch.backends.cuda.matmul
    was = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        def kern():
            return cuda_ms(lambda: sa.p1_sol(packed, w_in, w_ch, n_chain, ABL_EPOCHS,
                                             SCALE_TILE))[0]

        def lib():
            return cuda_ms(lambda: sol_library_chain(torch, packed, w_in, w_ch, n_chain,
                                                     ABL_EPOCHS))[0]

        kern(), lib()  # warm
        med, spread = in_turns(kern, lib)
    finally:
        mm.allow_bf16_reduced_precision_reduction = was
    return {"turns_ms": med["kernel"], "library_ms": med["library"], "spread": spread,
            "library_call": "24 torch.mm on bf16 (the last with out_dtype=float32), "
                            "allow_bf16_reduced_precision_reduction=False"}


def p1_wrong_sums(sa, ft, packed, plist, cfg, lw, nv):
    """P1-dx's sum from its plain version with one deliberate error each:
    {what is wrong: the sum} (P1-sol's: scripts/sol_checks.py)."""
    import dataclasses

    import torch

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


def tracker_graph_counts():
    """(graphs captured, steps replayed) by the port's tracker so far, or
    None before it is imported."""
    mpc = sys.modules.get(f"{PKG}.control.mpc")
    return None if mpc is None else (mpc.graph_captures, mpc.graph_steps)


@contextlib.contextmanager
def phase(name, budget_s):
    """Run one phase under a watchdog; print its JSON line at the end, with
    the tracker's CUDA-graph work in it (the step graphs captured and the
    steps replayed) where the phase ran the tracker."""
    faulthandler.dump_traceback_later(budget_s, exit=True)
    info = {}
    t0 = time.perf_counter()
    g0 = tracker_graph_counts()
    yield info
    faulthandler.cancel_dump_traceback_later()
    g1 = tracker_graph_counts()
    if g1 is not None and g1 != (g0 or (0, 0)):
        c0, r0 = g0 or (0, 0)
        info["tracker_graph"] = {"captures": g1[0] - c0, "steps_replayed": g1[1] - r0}
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


# the thread that opens the process's first profiler session (main)
PROFILER_WARM = None


def start_profiler_warm_up(torch, dev):
    """A thread that opens and closes one torch.profiler session over one
    kernel on ``dev``; → the started thread."""
    import threading

    def run():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def device_busy_ms(torch, fn):
    """(milliseconds of the device work that ``fn()`` ran, its count of
    device events) by ``torch.profiler``, read from the raw trace (building
    the profiler's event tree costs ~0.5 s for a few thousand kernels).
    Fails where the profiler records no device time: the phase's host
    share needs it."""
    from torch.profiler import ProfilerActivity, profile

    if PROFILER_WARM is not None:  # one session at a time in a process
        PROFILER_WARM.join()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    if not ns:
        fail("torch.profiler recorded no device time for the serve program")
    return sum(ns) / 1e6, len(ns)


def tracker_checks(np, torch, dev, card):
    """The captured tracker against the same kernels launched without a
    capture, the step kernels against their mirror and the torch step, the
    LU kernel's two forms against each other and its plain version, all
    timed (TRACK_GRAPH_*, MPC_*, LU_* above) → (the phase's info, the LU
    kernel's row fields, the step kernels' row fields)."""
    from defensive_model_vae_tpu_torch.control import mpc
    from defensive_model_vae_tpu_torch.control import tracker_inputs as tp
    from defensive_model_vae_tpu_torch.ops import _build
    from defensive_model_vae_tpu_torch.ops import lu_solve as lus
    from defensive_model_vae_tpu_torch.ops import mpc_step as ms
    from defensive_model_vae_tpu_torch.scripts import lu_checks as luc

    shapes = {}
    for B in TRACK_GRAPH_ROWS:
        for S in (TRACK_GRAPH_STEPS,):
            s0, refs, l0 = tp.inputs(B, S, dev)
            c0 = mpc.graph_captures
            a = mpc._simulate(tp.CFG, s0, refs, l0)
            c1 = mpc.graph_captures
            b = mpc._simulate(tp.CFG, s0, refs, l0)
            e = mpc._simulate_kernels(tp.CFG, s0, refs, l0)
            row = {"bit_for_bit": all(torch.equal(x, y) for x, y in zip(a, e)),
                   "replay_repeats": all(torch.equal(x, y) for x, y in zip(a, b)),
                   "captures_first_call": c1 - c0,
                   "captures_second_call": mpc.graph_captures - c1,
                   "finite": bool(torch.isfinite(a[0]).all())}
            shapes[f"{B}x{S}"] = row
            if not (row["bit_for_bit"] and row["replay_repeats"] and row["finite"]):
                fail(f"the captured tracker against the eager loop at {B} x {S}: {row}")
            if row["captures_second_call"]:
                fail(f"a second call at {B} x {S} captured the step again: {row}")
    emit({"tracker_graph_vs_eager": shapes})
    mpc_row = mpc_step_checks(torch, dev, mpc, tp, ms, lus)
    # the register form bit for bit the shared-memory form (and the host's
    # emulation of their arithmetic) on every case; on the tie cases the
    # wrong pivot rule's emulation unequal (scripts/lu_checks.py)
    forms = [luc.hold(*case) for case in luc.cases(dev)]
    emit({"lu_forms": forms})
    for row in forms:
        if not row["ok"]:
            fail(f"the LU kernel's register form against its shared-memory form: {row}")
    lib = _build.load("lu_solve")
    mirror = [n for n in range(1, lus.NMAX + 1)
              if lib.lu_solve_reg_bound(n) != (lus.instance(n)[1] if n <= lus.REG_BOUNDS[-1]
                                                else 0)]
    if mirror:
        fail(f"ops/lu_solve.py's choice of instance differs from the kernel's at n = {mirror}")
    lu = {}
    for B in LU_ROWS:
        H, g = luc.lm_systems(B, dev)
        k, p = lus.lu_solve(H, g), lus._lu_solve_plain(H, g)
        Hd, gd = H.double(), g.double()

        def backward(x):
            r = (Hd @ x.double() - gd).abs().amax(dim=(1, 2))
            norm = Hd.abs().sum(dim=2).amax(dim=1) * x.double().abs().amax(dim=(1, 2))
            return float((r / (norm + gd.abs().amax(dim=(1, 2)))).max())

        n = H.shape[1]
        x64 = torch.linalg.solve(Hd, gd)
        kappa = float((Hd.abs().sum(dim=2).amax(dim=1)
                       * torch.linalg.inv(Hd).abs().sum(dim=2).amax(dim=1)).max())
        gap = float((k.double() - p.double()).abs().max())
        lu[B] = {"backward_kernel": backward(k), "backward_plain": backward(p),
                 "backward_tol": n * LU_U, "gap": gap,
                 "gap_tol": 2 * kappa * n * LU_U * float(x64.abs().max()),
                 "kernel_vs_f64": float((k.double() - x64).abs().max()),
                 "plain_vs_f64": float((p.double() - x64).abs().max()), "kappa": kappa}
        if not (lu[B]["backward_kernel"] <= n * LU_U and gap <= lu[B]["gap_tol"]):
            fail(f"the LU kernel against solve_ex at {B} rows: {lu[B]}")
    emit({"lu_solve_vs_plain": lu})
    H, g = luc.lm_systems(SERVE_BATCH, dev)
    n = H.shape[1]
    form, instance = lus.instance(n)

    def smem(H, g):
        return lus.lu_solve(H, g, form="smem")

    def block(fn):
        return cuda_ms(lambda: [fn(H, g) for _ in range(LU_TIMED_CALLS)])[0] / LU_TIMED_CALLS

    def dev_block(fn):
        return device_ms(lambda: [fn(H, g) for _ in range(LU_TIMED_CALLS)], LU_TIMED_CALLS)

    block(lus.lu_solve), block(smem), block(lus._lu_solve_plain)  # warm
    med, spread = in_turns(lambda: block(lus.lu_solve), lambda: block(lus._lu_solve_plain))
    dmed, dspread = in_turns(lambda: dev_block(lus.lu_solve),
                             lambda: dev_block(lus._lu_solve_plain))
    # the serve path's form against the first form, in turns
    smed, sspread = in_turns(lambda: block(lus.lu_solve), lambda: block(smem))
    sdmed, sdspread = in_turns(lambda: dev_block(lus.lu_solve), lambda: dev_block(smem))
    flops = SERVE_BATCH * (2 * n ** 3 / 3 + 2 * n ** 2)
    b_ms, b_by = bound(flops, SERVE_BATCH * (n * n + 2 * n) * 4, FP32_FLOPS)
    row = {"max_abs_err": max(v["gap"] for v in lu.values()), "ms": med["kernel"],
           "device_ms": dmed["kernel"], "plain_ms": med["library"],
           "library_ms": med["library"], "library_device_ms": dmed["library"],
           "spread": {"ms": spread["kernel"], "device_ms": dspread["kernel"],
                      "library_ms": spread["library"],
                      "library_device_ms": dspread["library"]},
           "bound_ms": b_ms, "bound_by": b_by, "rows": SERVE_BATCH, "order": n,
           "form": form, "instance": instance,
           "smem_ms": smed["library"], "smem_device_ms": sdmed["library"],
           "form_turns": {"ms": smed, "device_ms": sdmed,
                          "spread": {"ms": sspread, "device_ms": sdspread}}}
    return {"graph_vs_eager": shapes, "lu_vs_plain": lu, "lu_forms_ok": len(forms),
            "card": card}, row, mpc_row


def mpc_step_checks(torch, dev, mpc, tp, ms, lus):
    """The step kernels against their mirror (one LM iteration, bit for bit)
    and the torch step (TRACK_GRAPH_*), and timed (MPC_* above) → the
    kernels' row fields."""
    from port_bench import mpc_step_flops
    from torch.profiler import ProfilerActivity, profile

    cfg, M = tp.CFG, tp.CFG.control_horizon
    k = mpc._problem(cfg, dev).consts
    mirror, vs_torch = {}, {}
    for B in TRACK_GRAPH_ROWS:
        s0, refs, l0 = tp.inputs(B, TRACK_GRAPH_STEPS, dev)
        gen = torch.Generator().manual_seed(B)
        u = (torch.randn((B, M, 2), generator=gen) * torch.tensor([3.0, 0.3])).to(dev)
        u[0, 0] = torch.tensor([7.0, -0.5])  # on the bounds: the clip's derivative 1/2
        last = (torch.randn((B, 2), generator=gen) * 0.3).to(dev)
        lam = torch.full((B,), 2e-3, device=dev)
        ref = refs[:, 1].contiguous()
        outs = {}
        for it, freeze in ((0, False), (2, True)):
            for name, form, update in (("kernel", ms.form, ms.update),
                                       ("mirror", ms._form_plain, ms._update_plain)):
                H = torch.empty((B, 2 * M, 2 * M), device=dev)
                g, c = torch.empty((B, 2 * M, 1), device=dev), torch.empty(B, device=dev)
                flags = torch.ones(B, dtype=torch.int32, device=dev)
                form(u, s0, ref, last, flags, lam, H, g, c, k, it, freeze)
                st = [u.clone(), s0.clone(), last.clone(), flags, lam.clone()]
                update(lus.lu_solve(H, g), st[0], st[1], ref, st[2], st[3], st[4], c, k, it,
                       it == 2)
                outs[(it, name)] = [H, g, c, *st]
        mirror[B] = all(torch.equal(x, y) for it in (0, 2)
                        for x, y in zip(outs[(it, "kernel")], outs[(it, "mirror")]))
        got = mpc._simulate(cfg, s0, refs, l0)
        want = mpc._simulate_eager(cfg, s0, refs, l0)
        gc = (got[1] - want[1]).abs()
        vs_torch[B] = {"state_max": float((got[0] - want[0]).abs().max()),
                       "control_mean_max": float(gc.mean(dim=1).max()),
                       "control_max": float(gc.max())}
        if not mirror[B]:
            fail(f"the step kernels against their mirror at {B} rows: not bit for bit")
        if vs_torch[B]["state_max"] > MPC_STATE_TOL or \
                vs_torch[B]["control_mean_max"] > MPC_CONTROL_MEAN_TOL:
            fail(f"the kernel step against the torch step at {B} rows: {vs_torch[B]}")
    emit({"mpc_step_vs_mirror": mirror, "mpc_step_vs_torch": vs_torch})
    timed = {}
    for B in MPC_TIMED_ROWS:
        s0, refs, l0 = tp.inputs(B, SERVE_STEPS, dev)
        mpc._simulate(cfg, s0, refs, l0)  # captured (or cached)
        ev_ms = min(cuda_ms(lambda: mpc._simulate(cfg, s0, refs, l0))[0] for _ in range(3))
        if PROFILER_WARM is not None:
            PROFILER_WARM.join()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mpc._simulate(cfg, s0, refs, l0)
            torch.cuda.synchronize()
        us = {"form": 0.0, "update": 0.0, "lu": 0.0, "all": 0.0}
        for e in prof.profiler.kineto_results.events():
            if not (str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0):
                continue
            name, d = e.name(), e.duration_ns() / 1e3 / SERVE_STEPS
            us["all"] += d
            for key, tag in (("form", "mpc_form_kernel"), ("update", "mpc_update_kernel"),
                             ("lu", "lu_reg_kernel")):
                us[key] += d if tag in name else 0.0
        plain = cuda_ms(lambda: mpc._simulate_eager(cfg, s0, refs[:, :MPC_PLAIN_STEPS], l0))[0]
        ops, nbytes = mpc_step_flops.step_flops_bytes(B, cfg.prediction_horizon, M,
                                                      cfg.lm_iters)
        b_ms, b_by = bound(ops, nbytes, FP32_FLOPS)
        timed[B] = {"step_event_us": 1e3 * ev_ms / SERVE_STEPS,
                    "device_us_per_step": us, "kernels_us_per_step": us["form"] + us["update"],
                    "bound_us_per_step": 1e3 * b_ms, "bound_by": b_by,
                    "plain_step_us": 1e3 * plain / MPC_PLAIN_STEPS}
    emit({"mpc_step_timed": timed})
    return {"bit_for_bit_mirror": mirror, "vs_torch_step": vs_torch, "timed": timed,
            "rows": list(MPC_TIMED_ROWS), "steps": SERVE_STEPS}


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
    from defensive_model_vae_tpu_torch.control import mpc as mpc_mod
    from defensive_model_vae_tpu_torch.control.mpc import _initial_tracker_state, _simulate
    from defensive_model_vae_tpu_torch.models import sample
    from defensive_model_vae_tpu_torch.ops import lu_solve as lus
    from defensive_model_vae_tpu_torch.ops import mpc_step as mst
    from defensive_model_vae_tpu_torch.pipeline import fixture_starts
    from defensive_model_vae_tpu_torch.train import load_checkpoint

    info = {"card": card}
    ckpts = {k: os.path.join(HERE, "results", "checkpoints", k)
             for k in ("sce1", "sce2", "sce3", "sce4")}
    t0 = time.perf_counter()
    c0 = mpc_mod.graph_captures
    server = serving.serve_checkpoint(ckpts, SERVE_BATCH, SERVE_STEPS, dt=SERVE_DT,
                                      port=0, warm_seed=1, device=dev)
    info["load_and_warm_s"] = time.perf_counter() - t0
    # the warm-up captures the step graph that the requests replay
    c1 = mpc_mod.graph_captures
    info["tracker_captures_warm"] = c1 - c0
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
        mst.reset_launches(dev)
        lus.reset_launches(dev)
        wall, code, body = _http(port, "/serve", req)
        # the request's launches of the step kernels and LU: lm_iters each a
        # replayed step (the graph was captured in the warm-up)
        launched = {**{kn: mst.launches(dev, kn) for kn in mst.KERNELS},
                    "lu": lus.launches(dev)}
        info["mpc_step_launches"] = launched
        if set(launched.values()) != {SERVE_STEPS * MPCConfig().lm_iters}:
            fail(f"the served request's step launches {launched}, expected "
                 f"{SERVE_STEPS * MPCConfig().lm_iters} each")
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
                    serve_fn_cuda_event_ms=ev_ms, ms_per_step=ev_ms / SERVE_STEPS,
                    tracker_captures_requests=mpc_mod.graph_captures - c1)
        if mpc_mod.graph_captures != c1:
            fail(f"the requests captured {mpc_mod.graph_captures - c1} tracker graphs "
                 "after the warm-up")

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

        # the same program with its step kernels launched without a
        # capture: bit for bit the captured one, and its wall beside the
        # request's
        real = mpc_mod._simulate
        mpc_mod._simulate = mpc_mod._simulate_kernels
        try:
            eager_fn = dr.make_serve_fn(p4, c4, mpc, SERVE_STEPS, m4.get("offset_mode", True))
        finally:
            mpc_mod._simulate = real
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_states = eager_fn(SERVE_SEED, pstarts, pinits)[0].cpu().numpy()
        info["eager_serve_fn_s"] = time.perf_counter() - t0
        if not np.array_equal(e_states, d_states):
            fail("the served states differ from the eager tracker's")
        info["graph_vs_eager_bit_for_bit"] = True

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


def dnda_pinned_frame(core, Road, Vehicle, np):
    """The pinned straight frame of tests/test_dnda.py:231, prepared."""
    speed, rel = 13.158535541215322, -0.04972614998298519
    ego = Vehicle(x=0.17449996586169148, y=0.8701448475755365, length=7.2, width=2.3,
                  speed=speed, speed_x=speed * np.cos(rel), speed_y=speed * np.sin(rel),
                  acc=1.4296171063502774, init_q=0.8701448475755365, lane_posi=1,
                  absolute_theta=0.0, relative_theta=rel)
    baseline = np.column_stack([np.arange(600) * 0.25 - 20.0, np.zeros(600)])
    sv = np.array([[16.0141393484983, 1.7887666332953127, 4.0, 2.0, -1.946066276384646,
                    0.0, 0.0, 0.0, 0.0]])
    return core.prepare_frame(3.0, 0.1, Road(False, 2, 2, 3.5, 9.8), ego, baseline, sv, 400)


def sut_chain(np, dev, trees, work):
    """The SUT chain on the first DNDA_TRACES_EACH committed traces of each
    scenario: each written back (``sut.writeback_npy_to_csv``) into the
    data phase's episode of its scenario whose ego track passes nearest the
    trace's start, saved under the name ``expected_csv_name`` asks for; the
    ``_def.csv`` files scored as ``DEF_<town>_<k>.csv`` by
    ``score_directory`` on the card (host preparation in a spawned pool of
    two) and on the host (inline; rows equal); TTC,
    PET and JERK on each by ``compute_metric`` and by the ``metrics``
    command (finite counts equal; sce4's written episodes hold sv1's
    acceleration at 0, so they have no SUT start row, and both say so)."""
    import io

    from defensive_model_vae_tpu_torch import cli, scenarios
    from defensive_model_vae_tpu_torch.data.csv_io import read_csv
    from defensive_model_vae_tpu_torch.dnda import score_directory
    from defensive_model_vae_tpu_torch.metrics import compute_metric
    from defensive_model_vae_tpu_torch.sut import (expected_csv_name,
                                                   parse_tracked_npy_name,
                                                   writeback_npy_to_csv)

    gen = os.path.join(HERE, "results", "GeneratedData")
    score = os.path.join(work, "score")
    os.makedirs(score)
    t0 = time.perf_counter()
    written = []
    for key in scenarios.keys():
        sce = scenarios.get(key)
        names = sorted(f for f in os.listdir(gen)
                       if f.startswith(f"tracked_trajectory_{key}_"))[:DNDA_TRACES_EACH]
        for k, name in enumerate(names, 1):
            x0, y0 = np.load(os.path.join(gen, name))[0, :2]
            best = min(trees[key], key=lambda p: float(np.min(
                np.hypot(read_csv(p)["ego_x"] - x0, read_csv(p)["ego_y"] - y0))))
            src = os.path.join(work, "src", sce.town)
            os.makedirs(src, exist_ok=True)
            shutil.copy(best, os.path.join(src, expected_csv_name(*parse_tracked_npy_name(name))))
            out = writeback_npy_to_csv(os.path.join(gen, name), os.path.join(work, "src"),
                                       os.path.join(work, "def"))
            dst = os.path.join(score, f"DEF_{sce.town}_{k}.csv")
            shutil.copy(out, dst)
            written.append((key, name, dst))
    writeback_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_rows = score_directory(score, device=dev, processes=2)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_rows = score_directory(score, host=True, processes=1)
    host_s = time.perf_counter() - t0
    if card_rows != host_rows:
        fail(f"score_directory on the card differs from the host pool: {card_rows} "
             f"against {host_rows}")
    def finite_count(fn):
        """fn()'s count of finite values, or the refusal's message."""
        try:
            return fn()
        except ValueError as e:
            return str(e)

    metrics = {}
    for key, name, path in written:
        counts = {}
        for metric in ("TTC", "PET", "JERK"):
            lib = finite_count(lambda: int(np.isfinite(
                compute_metric(path, key, metric)[metric]).sum()))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cmd = finite_count(lambda: cli.main(
                    ["metrics", "--scenario", key, "--csv", path, "--metric", metric])
                    or json.loads(buf.getvalue())["valid"])
            if cmd != lib:
                fail(f"{metric} on {name}: the metrics command gives {cmd!r}, "
                     f"compute_metric {lib!r}")
            counts[metric] = lib if isinstance(lib, int) else None
        metrics[name] = counts
    return {"traces": [n for _, n, _ in written], "writeback_s": writeback_s,
            "score_card_s": card_s, "score_host_s": host_s,
            "frames_scored": sum(r["frames"] for r in card_rows),
            "rows": [{"file_path": r["file_path"], "frames": r["frames"],
                      "max_dnda": r["max_dnda"] if r["frames"] else None}
                     for r in card_rows],
            "finite_metrics": metrics}


def dnda_phase(np, torch, dev, trees, card, work=None):
    """SUT risk scoring: the collision sweep on the card against the numpy
    oracle (256 synthetic frames, both SAT dtypes, index for index; DA/RL
    from finalize_frame bit for bit the host's), the pinned frame, the
    sweep's times at 3,072 frames, and the SUT chain (``sut_chain``), which
    writes its episodes under ``work`` (a temporary directory if None)."""
    from defensive_model_vae_tpu_torch.dnda import Road, Vehicle, core, spline
    from defensive_model_vae_tpu_torch.scripts import dnda_sweep

    t0 = time.perf_counter()
    info = {"spline_library": spline.build().name}  # g++, unless built already
    info["spline_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preps = dnda_sweep.synthetic_frames(DNDA_FRAMES, DNDA_SEED)
    info["prepare_s"] = time.perf_counter() - t0
    info.update(dnda_sweep.shapes(preps))
    t0 = time.perf_counter()
    host = core.sweep_frames(preps, host=True)
    host_s = time.perf_counter() - t0
    host_da_rl = [core.finalize_frame(p, ci) for p, ci in zip(preps, host)]
    if any(not (0.0 <= rl <= 1.0 and da >= 0.0) for da, rl in host_da_rl):
        fail("a frame's RL lies outside [0, 1] or its DA below 0")
    for dt in dnda_sweep.DTYPES:
        got = core.sweep_frames(preps, device=dev, sat_dtype=dt)
        bad = [i for i, (g, h) in enumerate(zip(got, host)) if not np.array_equal(g, h)]
        if len(got) != len(preps) or bad:
            fail(f"the {dt} sweep on the card differs from the numpy oracle on frames "
                 f"{bad[:10]}: {[(got[i].tolist(), host[i].tolist()) for i in bad[:3]]}")
        if [core.finalize_frame(p, ci) for p, ci in zip(preps, got)] != host_da_rl:
            fail(f"DA/RL after the {dt} card sweep differ from the host's")
    n_paths = sum(len(ci) for ci in host)
    hits = sum(int((ci < np.ceil(p.ego_speed * p.time_horizon
                                 / np.asarray(p.unit_arc_paths))).sum())
               for p, ci in zip(preps, host))
    info.update(paths_swept=n_paths, paths_hit=hits,
                frames_rl_positive=sum(rl > 0 for _, rl in host_da_rl))
    prep = dnda_pinned_frame(core, Road, Vehicle, np)
    da, rl = core.finalize_frame(prep, core.sweep_frames([prep], device=dev)[0])
    if abs(da - DNDA_PINNED["da"]) > DNDA_PINNED["da_tol"] or \
            abs(rl - DNDA_PINNED["rl"]) > DNDA_PINNED["rl_tol"]:
        fail(f"the pinned frame gives DA {da}, RL {rl} after the card sweep")
    info["pinned"] = {"da": da, "rl": rl}
    tiled = (preps * -(-DNDA_TILE // len(preps)))[:DNDA_TILE]
    for dt in dnda_sweep.DTYPES:
        info[f"sweep_{dt}"] = dnda_sweep.time_sweep(tiled, dev, dt, DNDA_REPS)
    info["host_sweep_s"] = host_s
    info["host_sweep_s_scaled"] = host_s * len(tiled) / len(preps)
    if work is None:
        with tempfile.TemporaryDirectory() as tmp:
            info["sut"] = sut_chain(np, dev, trees, tmp)
    else:
        info["sut"] = sut_chain(np, dev, trees, work)
    info["card"] = card
    return info


def conv_phase(np, torch, dev, card):
    """BASELINE config 3 on the card (``train_conv`` at the bench shape), its
    20 first epochs against the CPU's, sampling away from the origin, and a
    Conv1D checkpoint's round trip."""
    from defensive_model_vae_tpu_torch.data import generate_random_trajectories
    from defensive_model_vae_tpu_torch.models import (ConvCVAEConfig, conv_sample,
                                                      init_conv_params)
    from defensive_model_vae_tpu_torch.train import (TrainConfig, load_checkpoint,
                                                     params_to_numpy, save_checkpoint,
                                                     train_conv)
    from defensive_model_vae_tpu_torch.train.train import epoch_noise

    w = generate_random_trajectories(CONV_N, CONV_SEQ, CONV_STEP, seed=0).astype(np.float32)
    cfg = ConvCVAEConfig(seq_len=CONV_SEQ, dim=w.shape[2])
    info = {"n": CONV_N, "seq_len": CONV_SEQ, "dim": cfg.dim, "epochs": CONV_EPOCHS,
            "n_params": cfg.n_params()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, (params, hist, _) = cuda_ms(lambda: train_conv(
        w, cfg, TrainConfig(epochs=CONV_EPOCHS), device=dev))
    wall = time.perf_counter() - t0
    first, last = float(hist["total"][0]), float(hist["total"][-1])
    info.update(wall_s=wall, cuda_ms=ms, ms_per_epoch=ms / CONV_EPOCHS,
                windows_per_s=CONV_EPOCHS * CONV_N / wall, loss_first=first,
                loss_last=last)
    if not all(np.all(np.isfinite(v)) for v in hist.values()) or not last < first / 3:
        fail(f"train_conv did not converge: loss {first} -> {last}")

    # the card against the CPU on the same init and noise
    init = init_conv_params(torch.Generator().manual_seed(1), cfg, "cpu")
    eps = np.stack([epoch_noise(1, e, (CONV_N, cfg.latent_dim)).numpy()
                    for e in range(CONV_CHECK_EPOCHS)])
    tc = TrainConfig(epochs=CONV_CHECK_EPOCHS, seed=1)
    t0 = time.perf_counter()
    pc, hc, _ = train_conv(w, cfg, tc, init_params=init, eps=eps, device="cpu")
    cpu_s = time.perf_counter() - t0
    pg, hg, _ = train_conv(w, cfg, tc, init_params=init, eps=eps, device=dev)
    pg2, hg2, _ = train_conv(w, cfg, tc, init_params=init, eps=eps, device=dev)
    twice = all(np.array_equal(hg[k], hg2[k]) for k in hg) and all(
        torch.equal(pg[k][n], pg2[k][n]) for k in pg for n in ("w", "b"))
    if not twice:
        fail("train_conv on the card is not run to run equal under cuDNN's "
             "deterministic algorithms")

    def row_gaps(h):  # each epoch's largest gap of a row, relative to the row
        return np.max([np.abs(h[k] - hc[k]) / np.abs(hc[k]).max() for k in hc], axis=0)

    gaps = row_gaps(hg)
    g = torch.Generator().manual_seed(2)  # the CPU's own sensitivity: init one ulp off
    nudged = {k: {n: torch.nextafter(a, torch.where(torch.rand(a.shape, generator=g) < 0.5,
                                                    -torch.inf, torch.inf))
                  for n, a in v.items()} for k, v in init.items()}
    ulp = row_gaps(train_conv(w, cfg, tc, init_params=nudged, eps=eps, device="cpu")[1])
    first = float(gaps[:CONV_TOL["first_epochs"]].max())
    a, b = params_to_numpy(pg), params_to_numpy(pc)
    pabs = max(float(np.abs(a[k][n] - b[k][n]).max()) for k in a for n in ("w", "b"))
    info["vs_cpu"] = {"epochs": CONV_CHECK_EPOCHS, "first_epochs_max_rel": first,
                      "metrics_max_rel": float(gaps.max()),
                      "worst_epoch": int(gaps.argmax()) + 1,
                      "cpu_one_ulp_rel": float(ulp.max()), "params_max_abs": pabs,
                      "card_run_to_run_equal": twice,
                      "tol": CONV_TOL, "cpu_s": cpu_s}
    if first > CONV_TOL["first_rel"] or gaps.max() > CONV_TOL["metrics_rel"] or \
            pabs > CONV_TOL["params_abs"]:
        fail(f"train_conv on the card differs from the CPU's: {info['vs_cpu']}")

    # sampling from starts away from the origin
    starts = (np.asarray(CONV_STARTS_AT) + np.random.default_rng(2).uniform(
        -CONV_STARTS_SPREAD, CONV_STARTS_SPREAD, (CONV_N, 2))).astype(np.float32)
    t0 = time.perf_counter()
    ps, hs, _ = train_conv(w - w[:, :1] + starts[:, None], cfg,
                           TrainConfig(epochs=CONV_SAMPLE_EPOCHS), device=dev)
    out = conv_sample(ps, torch.Generator().manual_seed(1),
                      torch.as_tensor(starts, device=dev), cfg).cpu().numpy()
    gap = np.linalg.norm(out[:, 0] - starts, axis=1)
    info["sample"] = {"epochs": CONV_SAMPLE_EPOCHS, "seconds": time.perf_counter() - t0,
                      "loss_first": float(hs["total"][0]),
                      "loss_last": float(hs["total"][-1]),
                      "first_point_max_m": float(gap.max()),
                      "first_point_mean_m": float(gap.mean()), "limit_m": CONV_START_M}
    if out.shape != (CONV_N, CONV_SEQ, cfg.dim) or not np.all(np.isfinite(out)) \
            or gap.max() >= CONV_START_M:
        fail(f"conv_sample's first points are off their starts: {info['sample']}")

    # a Conv1D checkpoint comes back a ConvCVAEConfig with the same params
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, cfg, None, hist)
        p2, cfg2, _ = load_checkpoint(d, dev)
    if not isinstance(cfg2, ConvCVAEConfig) or cfg2 != cfg or set(p2) != set(params) or \
            not all(torch.equal(p2[k][n], params[k][n]) for k in params for n in ("w", "b")):
        fail(f"a Conv1D checkpoint did not load back as saved: {cfg2!r}")
    info.update(checkpoint="ConvCVAEConfig, params bit for bit", card=card)
    return info


def parallel_phase(np, torch, dev, ws, w4, card, world=None):
    """The data-parallel tier on the card (PAR_* above): a gloo world of two
    spawned ranks sharing the card, held to one device, and meanwhile a NCCL
    world of one in this process, bit for bit mesh=None; K4's dp launches.
    ``world``: the gloo world of two, started (``parallel.start_world``)
    before the phases that its start-up runs beside, else started here.  With
    ``dev`` the CPU (a rehearsal) the world of one is gloo's too and the
    launch counts, which count CUDA launches, are not held."""
    import torch.distributed as dist

    from defensive_model_vae_tpu_torch.control import MPCConfig, track_batch
    from defensive_model_vae_tpu_torch.control import device_reference as dr
    from defensive_model_vae_tpu_torch.control.device_reference import make_serve_fn
    from defensive_model_vae_tpu_torch.dnda import core
    from defensive_model_vae_tpu_torch.ops import fused_scale as fs
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.parallel import create_mesh, start_world, worlds
    from defensive_model_vae_tpu_torch.pipeline import fixture_starts
    from defensive_model_vae_tpu_torch.scripts import dnda_sweep
    from defensive_model_vae_tpu_torch.serving import SERVE_HORIZONS
    from defensive_model_vae_tpu_torch.train import (TrainConfig, load_checkpoint,
                                                     params_to_numpy, train)

    keys = ("total", "recon", "kld", "start", "time")
    if world is None:
        world = start_world(2, "gloo", dev.type, timeout_s=PAR_WORLD_S)
    # the gloo world's call goes first; this process runs the NCCL world of
    # one and the one-device references meanwhile
    wg = ws[:PAR_GLOO_N]
    eps = np.random.default_rng(1).normal(size=(PAR_GLOO_N, 8)).astype(np.float32)
    gkw = dict(epochs=PAR_GLOO_EPOCHS, tile=SCALE_TILE, compute_dtype=None, eps=eps)
    w16 = w4[PAR_FIRST_START:PAR_FIRST_START + 16]
    starts, inits = fixture_starts(w16)
    wps = w16[:, :, [1, 2, 0]].astype(float)
    wps[:, 0, 2] = 0.0
    mpc = MPCConfig(**PAR_MPC)
    sp, scfg, _ = load_checkpoint(os.path.join(HERE, "results", "checkpoints", "sce4"),
                                  "cpu")
    smpc = MPCConfig(prediction_horizon=SERVE_HORIZONS[0],
                     control_horizon=SERVE_HORIZONS[1], dt=SERVE_DT)
    preps = dnda_sweep.synthetic_frames(PAR_SWEEP_FRAMES, DNDA_SEED)
    pkg = "defensive_model_vae_tpu_torch"
    calls = [
        (worlds.gloo_cuda_probe, (), {}),
        (worlds.timed, (worlds.dp_timed, wg), gkw),
        (worlds.timed, (worlds.call_with_mesh, f"{pkg}.control.mpc:track_batch", wps,
                        inits, mpc), {}),
        (worlds.timed, (worlds.serve_program, params_to_numpy(sp), smpc, PAR_SERVE_STEPS,
                        SERVE_SEED, starts, inits), {"model_cfg": scfg}),
        (worlds.timed, (worlds.call_with_mesh, f"{pkg}.dnda.core:sweep_frames", preps), {}),
    ]
    called = time.time()
    world.submit(worlds.run_all, (calls,))

    # ---- a NCCL world of one: bit for bit mesh=None
    cuda = dev.type == "cuda"
    backend = "nccl" if cuda else "gloo"
    mesh = create_mesh(backend=backend, device=dev)
    if mesh.backend != backend or mesh.shape != {"data": 1, "model": 1}:
        fail(f"the world is {mesh.backend} {mesh.shape}, not {backend} of one")
    wd = ws[:PAR_DP_N]
    dkw = dict(epochs=PAR_DP_EPOCHS, tile=SCALE_TILE, compute_dtype="bfloat16",
               noise="hbm", seed=0)
    fs._grad_epoch_call.launches = 0
    nccl = worlds.dp_timed(dev, wd, **dkw)
    dp_launches = fs._grad_epoch_call.launches
    if cuda and (dp_launches != PAR_DP_EPOCHS or nccl["k4_launches"] != PAR_DP_EPOCHS):
        fail(f"the dp tier launched K4 {dp_launches} times over {PAR_DP_EPOCHS} epochs")
    p1, h1 = fs.fused_train_scale_dp(wd, device=dev, **dkw)
    same_dp = all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(
        ft._flatten_params(nccl["params"]), ft._flatten_params(p1))) and \
        all(np.array_equal(nccl["history"][k], h1[k]) for k in keys)
    tc = TrainConfig(epochs=PAR_TRAIN_EPOCHS)
    pm, hm = train(w4, train_cfg=tc, mesh=mesh)
    p0, h0 = train(w4, train_cfg=tc, device=dev)
    same_train = all(torch.equal(pm[k][n], p0[k][n]) for k in p0 for n in ("w", "b")) and \
        all(np.array_equal(hm[k], h0[k]) for k in keys)
    dist.destroy_process_group()
    info = {"nccl": {"world": 1, "backend": mesh.backend, "dp_rows": PAR_DP_N,
                     "dp_epochs": PAR_DP_EPOCHS, "tile": SCALE_TILE, "dtype": "bfloat16",
                     "noise": "hbm", "dp_wall_s": nccl["wall_s"],
                     "k4_ms_per_launch": nccl["k4_ms"],
                     "allreduce_ms_per_epoch": nccl["allreduce_ms"],
                     "k4_launches": dp_launches, "dp_bit_for_bit": same_dp,
                     "train_epochs": PAR_TRAIN_EPOCHS, "train_bit_for_bit": same_train,
                     "card": card}}
    if not (same_dp and same_train):
        fail(f"a NCCL world of one differs from mesh=None: {info['nccl']}")

    # ---- the one-device runs the gloo world is held to
    pg, hg = fs.fused_train_scale_dp(wg, device=dev, **gkw)
    _, st1, ct1, steps1 = track_batch(wps, inits, mpc, device=dev)
    spd = {k: {n: a.to(dev) for n, a in v.items()} for k, v in sp.items()}
    serve = make_serve_fn(spd, scfg, smpc, PAR_SERVE_STEPS)
    sv_st, sv_ct = (a.cpu().numpy() for a in serve(SERVE_SEED, starts, inits))
    # the one-device program on each rank's block of 8 rows (the same draws)
    z = dr.request_draws(SERVE_SEED, len(starts), dr._N_DRAWS, scfg.latent_dim, dev)
    blocks = [slice(r * 8, (r + 1) * 8) for r in range(2)]
    by_block = [(track_batch(wps[b], inits[b], mpc, device=dev),
                 [a.cpu().numpy() for a in serve(SERVE_SEED, starts[b], inits[b], z[b])])
                for b in blocks]
    sw1 = core.sweep_frames(preps, device=dev)
    host = core.sweep_frames(preps, host=True)
    try:
        out = world.result()
    except (RuntimeError, TimeoutError) as e:
        fail(f"the gloo world of two failed: {e}")
    result_s = time.time() - called  # the call to its results, this process's work between
    tol = PAR_TOL
    gaps, ranks = {}, []
    failed = []
    for r, (probe, (dp_s, dp), (tr_s, tr), (sv_s, sv), (sw_s, sw)) in enumerate(out):
        _, st, ct, steps = tr
        (_, bst, bct, bsteps), (bsv_st, bsv_ct) = by_block[r]
        n = bst.shape[1]  # the block's steps, rounded up as its longest path's
        mine = blocks[r]
        g = {"dp_params": max(float(np.abs(a - b.cpu().numpy()).max()) for a, b in zip(
                 ft._flatten_params(dp["params"]), ft._flatten_params(pg))),
             "dp_hist_rel": max(float((np.abs(dp["history"][k] - hg[k])
                                       / (tol["hist_atol"] + tol["hist_rtol"]
                                          * np.abs(hg[k]))).max()) for k in keys),
             "track_states": float(np.abs(st - st1).max()),
             "track_controls": float(np.abs(ct - ct1).max()),
             "serve_states": float(np.abs(sv[0] - sv_st).max()),
             "serve_controls": float(np.abs(sv[1] - sv_ct).max()),
             "block_bit_for_bit": bool(
                 np.array_equal(st[mine, :n], bst) and np.array_equal(ct[mine, :n - 1], bct)
                 and np.array_equal(sv[0][mine], bsv_st)
                 and np.array_equal(sv[1][mine], bsv_ct)),
             "sweep_frames_off": sum(not (np.array_equal(a, b) and np.array_equal(a, h))
                                     for a, b, h in zip(sw, sw1, host))
             + abs(len(sw) - len(preps))}
        gaps[r] = g
        clock = {k: probe.pop(k) - world.started
                 for k in ("entry", "joined", "called", "entered")}
        ranks.append({"rank": r, "probe": probe, "start_up_s": clock,
                      "call_s": clock["called"] - (called - world.started),
                      "dp_wall_s": dp["wall_s"],
                      "k4_ms_per_launch": dp["k4_ms"],
                      "allreduce_ms_per_epoch": dp["allreduce_ms"],
                      "k4_launches": dp["k4_launches"], "block_rows": dp["block_rows"],
                      "track_s": tr_s, "serve_s": sv_s, "sweep_s": sw_s})
        if (g["dp_params"] > tol["params_abs"] or g["dp_hist_rel"] > 1.0
                or not g["block_bit_for_bit"]
                or max(g["track_states"], g["track_controls"], g["serve_states"],
                       g["serve_controls"]) > SERVE_HOST_TRACK_TOL
                or g["sweep_frames_off"] or not np.array_equal(steps, steps1)
                or not np.array_equal(bsteps, steps1[mine])
                or cuda and dp["k4_launches"] != PAR_GLOO_EPOCHS):
            failed.append(r)
    info["gloo"] = {"world": 2, "label": PAR_GLOO_LABEL, "result_s": result_s,
                    "dp_rows": PAR_GLOO_N, "dp_epochs": PAR_GLOO_EPOCHS, "dtype": "float32",
                    "noise": "packed", "serve_steps": PAR_SERVE_STEPS,
                    "sweep_frames": PAR_SWEEP_FRAMES, "track_rows": 16, "tol": tol,
                    "full_batch_tol": SERVE_HOST_TRACK_TOL,
                    "gaps": gaps, "ranks": ranks, "card": card}
    info["dp_launches"] = dp_launches
    if failed:
        emit({"parallel_gaps": info["gloo"]})
        fail(f"ranks {failed} of the gloo world differ from one device: {gaps}")
    return info


def k2_option_checks(np, torch, dev, corpora, cfg, lw):
    """K2's use_mask=False and _metrics="static" on the card against the
    plain version and the full store (DRV_* above) → (rows, the largest
    params gap of the unmasked runs)."""
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.models import init_params

    keys = sorted(corpora)
    n_max = max(len(w) for w in corpora.values())
    ins = [ft.fused_inputs(np.concatenate([w, np.repeat(w[:1], n_max - len(w), 0)]), dev)
           for w in (corpora[k] for k in keys)]
    x = torch.stack([a for a, _ in ins])
    c = torch.stack([b for _, b in ins])
    mask = torch.zeros((len(keys), n_max, 1))
    for i, k in enumerate(keys):
        mask[i, :len(corpora[k])] = 1.0
    eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (len(keys), n_max, cfg.latent_dim)).astype(np.float32)).to(dev)
    seeds = list(range(len(keys)))
    st = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                               for q in seeds])
    xr, cr, off, er = ft.padded_rows(x, c, mask, eps, use_mask=False)
    rows, worst = [], 0.0
    for ep in (1, 50):
        plain = ft._fused_multi_call_plain(st, xr, cr, off, seeds, cfg, lw, ep, 1e-3, er)
        full = ft._fused_multi_call_padded(st, x, c, mask, seeds, cfg, lw, ep, 1e-3, eps,
                                           use_mask=False)
        gaps, ok = grid_gaps(full, plain, GRID_TOL[ep])
        row = {"kernel": "K2 use_mask=False", "rows": off, "epochs": ep, **gaps}
        worst = max(worst, gaps["params_max_abs"])
        if ep == 50:
            spread = grid_gaps(ft._fused_multi_call_plain(one_ulp(st), xr, cr, off, seeds,
                                                          cfg, lw, ep, 1e-3, er),
                               plain, GRID_TOL[ep])[0]
            row["plain_one_ulp"] = spread
            row["metrics_held_vs"] = "plain_one_ulp metrics_max_rel_to_total"
            ok = (gaps["params_max_abs"] <= GRID_TOL[ep]["params_abs"]
                  and gaps["metrics_max_rel_to_total"] <= spread["metrics_max_rel_to_total"])
            static = ft._fused_multi_call_padded(st, x, c, mask, seeds, cfg, lw, ep, 1e-3,
                                                 eps, use_mask=False, _metrics="static")
            row["static_params_bit_for_bit_full"] = all(
                torch.equal(a, b) for a, b in zip(static[0], full[0]))
            row["static_row0_is_full_last_row"] = torch.equal(static[1][:, 0], full[1][:, -1])
            row["static_rows_after_0_zero"] = bool((static[1][:, 1:] == 0).all())
            ok = ok and row["static_params_bit_for_bit_full"] and \
                row["static_row0_is_full_last_row"] and row["static_rows_after_0_zero"]
        rows.append(row)
        emit({"k2_options_vs_plain": row})
        if not ok:
            fail(f"K2's options disagree with the plain version or the full store: {row}")
    return rows, worst


def drivers_phase(np, torch, dev, corpora, cfg, lw, card):
    """The port's research drivers at full width and cut depth (DRV_* above):
    grid_probe, run_baseline_configs, serve_latency, hot_probe and
    mint_provenance_probe (its P3 builds in a thread beside the others),
    robustness_row; each driver's kernel launches counted from 0 just before
    it and read just after → (the phase's record, K2's options' largest
    params gap).  With ``dev`` the CPU (a rehearsal, at sizes set by the
    caller) the launch counts, which count CUDA launches, are not held."""
    import threading

    from defensive_model_vae_tpu_torch.ops import fused_scale as fs
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.scripts import (grid_probe, hot_probe,
                                                       mint_provenance_probe, robustness_row,
                                                       run_baseline_configs, serve_latency)

    info, launches, times = {}, {}, {}
    mint = {}

    def mint_run():
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            try:
                mint["out"] = mint_provenance_probe.probe(pathlib.Path(work), build=True)
            except Exception as e:  # noqa: BLE001 (reported and failed below)
                mint["error"] = repr(e)
            mint["seconds"] = time.perf_counter() - t0

    mint_thread = threading.Thread(target=mint_run, daemon=True)
    mint_thread.start()

    t0 = time.perf_counter()
    info["k2_options"], k2_opt_err = k2_option_checks(np, torch, dev, corpora, cfg, lw)
    times["k2_options"] = time.perf_counter() - t0

    def counted(name, fn):
        ft.fused_call.launches = ft._fused_multi_call.launches = 0
        ft._fused_multi_call.static_launches = ft._fused_multi_call.unmasked_launches = 0
        fs._fused_scale_call.launches = 0
        fs._fused_scale_call.knob_launches["dwT"] = 0
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        launches[name] = {"k1": ft.fused_call.launches, "k2": ft._fused_multi_call.launches,
                          "k2_static": ft._fused_multi_call.static_launches,
                          "k2_unmasked": ft._fused_multi_call.unmasked_launches,
                          "k3": fs._fused_scale_call.launches,
                          "k3_dwT": fs._fused_scale_call.knob_launches["dwT"]}
        return out

    grid = counted("grid_probe", lambda: grid_probe.run_probe(
        grid_probe.SEEDS, DRV_GRID_EPOCHS, 1, dev))
    if any(not all(np.isfinite(v["all_s"])) for v in grid["variants"].values()):
        fail(f"grid_probe timed a variant as non-finite: {grid['variants']}")
    base = counted("run_baseline_configs", lambda: run_baseline_configs.run(
        DRV_BASE_EPOCHS, DRV_CONV_EPOCHS, os.path.join(HERE, "DefensiveData"), dev))
    pairs = [(k, base[k]["loss_first"], base[k]["final_loss"])
             for k in ("config1_dense_sce1", "config4_conditioned")]
    pairs.append(("config3_conv_long_windows", base["config3_conv_long_windows"]["loss_first"],
                  base["config3_conv_long_windows"]["loss_final"]))
    c2 = base["config2_four_scenarios"]
    pairs += [(f"config2 {k}", c2["first_losses"][k], c2["final_losses"][k])
              for k in c2["final_losses"]]
    bad = [p for p in pairs if not (np.isfinite(p[2]) and p[2] < p[1])]
    no_kernel = dev.type == "cuda" and "kernel launch" not in c2["mode"]
    if bad or not c2["generated_finite"] or no_kernel:
        fail(f"run_baseline_configs: losses not finite and descending ({bad}), samples "
             f"not finite, or no kernel launched: {c2}")
    serve = counted("serve_latency", lambda: serve_latency.measure(
        serve_latency.CKPT, DRV_SERVE_STEPS, DRV_SERVE_REPS, SERVE_BATCH, DRV_CONCURRENCY,
        DRV_LOAD_REQUESTS, dev))
    tail = serve["serve_tail_under_load"]
    if tail["errors"] or tail["requests"] != DRV_CONCURRENCY * DRV_LOAD_REQUESTS:
        fail(f"serve_latency: {tail['errors']} errors under load: {tail}")
    hot = counted("hot_probe", lambda: hot_probe.run_probe(
        SCALE_N, DRV_HOT_EPOCHS, SCALE_TILE, 1, dev))
    t0 = time.perf_counter()
    row = robustness_row.build()
    times["robustness_row"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mint_thread.join(timeout=120)
    times["mint_wait"] = time.perf_counter() - t0
    if mint_thread.is_alive() or "error" in mint:
        fail(f"mint_provenance_probe did not finish: {mint.get('error', 'timed out')}")
    m = mint["out"]
    if m["comment_line_in_cu_rekeys"] != ["fused_scale"] or m["checkout_path_rekeys"] \
            or not m["a_deterministic_across_loads"]:
        fail(f"mint_provenance_probe: unexpected keys: {m}")
    times["mint_provenance_probe"] = mint["seconds"]
    want = {"grid_probe": {"k1": 2 * grid_probe.SEEDS, "k2": 8, "k2_static": 2,
                           "k2_unmasked": 6},
            "run_baseline_configs": {"k1": 2, "k2": 1}, "hot_probe": {"k3": 10, "k3_dwT": 4}}
    for name, counts in want.items():
        got = {k: launches[name][k] for k in counts}
        if dev.type == "cuda" and got != counts:
            fail(f"{name} launched {got}, expected {counts}")
    info.update(
        depth={"grid_epochs": DRV_GRID_EPOCHS, "grid_reps": 1, "baseline_epochs": DRV_BASE_EPOCHS,
               "conv_epochs": DRV_CONV_EPOCHS, "serve_steps": DRV_SERVE_STEPS,
               "serve_reps": DRV_SERVE_REPS, "concurrency": DRV_CONCURRENCY,
               "load_requests": DRV_LOAD_REQUESTS, "hot_epochs": DRV_HOT_EPOCHS, "hot_reps": 1},
        grid_probe=grid, baseline_configs=base,
        serve_latency={k: serve[k] for k in ("serve", "generate", "serve_tail_under_load",
                                             "serve_throughput", "startup_s", "diverged_rows",
                                             "total_request_rows")},
        hot_probe=hot, mint_provenance_probe=m,
        robustness_row_cells_beating=sum(c["median_beats"] for sc in row["scenarios"].values()
                                         for c in sc["cells"].values()),
        launches=launches, driver_s=times, budget_s=DRV_BUDGET_S, card=card)
    return info, k2_opt_err


def driver_line(main_fn, argv, key):
    """A research driver's ``main(argv)`` in process → the payload of its one
    JSON line on stdout (fails on another exit code or more lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if rc != 0 or len(lines) != 1:
        fail(f"{key} exited {rc} with {len(lines)} lines on stdout: {buf.getvalue()[-2000:]}")
    return json.loads(lines[0])[key]


def scoreboard_phase(np, torch, dev, ep_root, sut_dir, card):
    """The scoreboard and the last four research drivers (SB_* above) on the
    data phase's episode trees (``ep_root``) and the dnda phase's SUT
    episodes (``sut_dir``), with the committed checkpoints at full width →
    (the phase's record, K2's launches in ``stage_timings``).  Every number
    of the scoreboard describes the written trees, not the human data."""
    import io

    from defensive_model_vae_tpu_torch import cli, scenarios
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.pipeline import reproduce_scoreboard
    from defensive_model_vae_tpu_torch.scripts import (dnda_drift_probe, multiseed_validate,
                                                       seed_sweep, stage_timings)
    from defensive_model_vae_tpu_torch.utils import jsonable

    info, times = {}, {}
    keys = list(scenarios.keys())
    ckpt_root = os.path.join(HERE, "results", "checkpoints")
    with tempfile.TemporaryDirectory() as work:
        # ---- reproduce_scoreboard: the four scenarios at the recorded seeds
        out = os.path.join(work, "out")
        os.makedirs(out)
        recorded = {}
        for k in keys:
            shutil.copy(os.path.join(HERE, "results", f"validation_{k}.json"), out)
            with open(os.path.join(out, f"validation_{k}.json")) as f:
                recorded[k] = json.load(f)["provenance"]["seed"]
        t0 = time.perf_counter()
        first = reproduce_scoreboard(ckpt_root, ep_root, out, device=dev)
        times["reproduce"] = time.perf_counter() - t0
        for k in keys:
            with open(os.path.join(out, f"validation_{k}.json")) as f:
                art = json.load(f)
            report = first[k]["report"]
            metrics = {m: v for m, v in art.items() if m != "provenance"}
            # each metric finite, or null exactly where the report's is not
            bad = [m for m, v in metrics.items()
                   if not (v == report[m] and np.isfinite(v) if v is not None
                           else not np.isfinite(report[m]))]
            pub = scenarios.get(k).published_best
            if art["provenance"]["seed"] != recorded[k] or bad or \
                    set(first[k]["board"]) != set(pub) or \
                    any(c["published_best"] != pub[m] for m, c in first[k]["board"].items()):
                fail(f"reproduce_scoreboard on {k}: seed {art['provenance']['seed']} "
                     f"(recorded {recorded[k]}), metrics {bad} not finite or not the "
                     f"report's, board {first[k]['board']}")
        with open(os.path.join(out, "scoreboard.json")) as f:
            if json.load(f) != jsonable({k: first[k]["board"] for k in keys}):
                fail("scoreboard.json is not the returned board")
        def cli_reproduce(out_dir, scenario_keys):
            """``cli.py reproduce --check`` in process → (exit code, stdout)."""
            buf, code = io.StringIO(), 0
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(["reproduce", "--ckpt-root", ckpt_root, "--data-root", ep_root,
                              "--out", out_dir, "--scenarios", ",".join(scenario_keys),
                              "--check", "--device", str(dev)])
            except SystemExit as e:
                code = e.code
            return code, buf.getvalue()

        # the check rerun, through the CLI: every scenario at its recorded
        # seed against the artifacts the first run wrote, no failure
        t0 = time.perf_counter()
        code, text = cli_reproduce(out, keys)
        times["reproduce_check"] = time.perf_counter() - t0
        if code != 0 or "CHECK OK" not in text:
            fail(f"the check rerun at the same seeds exited {code}: {text[-3000:]}")
        # one committed metric moved: the CLI's check must fail on it alone
        key, metric, delta = SB_PERTURB
        moved = os.path.join(work, "moved")
        shutil.copytree(out, moved)
        path = os.path.join(moved, f"validation_{key}.json")
        with open(path) as f:
            art = json.load(f)
        art[metric] += delta
        with open(path, "w") as f:
            json.dump(art, f)
        t0 = time.perf_counter()
        code, text = cli_reproduce(moved, [key])
        times["reproduce_moved"] = time.perf_counter() - t0
        head, _, failed = text.partition("CHECK FAILED")
        caught = json.loads(failed[failed.index("\n"):]) if failed else {}
        if code != 1 or set(caught) != {key} or set(caught[key]) != {metric}:
            fail(f"a {metric} moved by {delta} gave exit {code} and failures {caught}")
        beats = {k: sum(c["beats"] for c in first[k]["board"].values()) for k in keys}
        print(f"scoreboard beats (written trees, not the human data): {beats}", flush=True)
        info["reproduce"] = {
            "data": "written trees, not the human data", "seeds": recorded, "beats": beats,
            "cells": {k: len(first[k]["board"]) for k in keys},
            "metrics": {k: {m: v for m, v in first[k]["report"].items() if m != "provenance"}
                        for k in keys},
            "check": "CHECK OK", "moved_caught": caught[key]}

        # ---- seed_sweep on sce2
        t0 = time.perf_counter()
        sweep_file = os.path.join(work, "seed_sweep.json")
        doc = driver_line(seed_sweep.main, [
            "--scenario", "sce2", "--train-seeds", SB_SWEEP_SEEDS, "--epochs",
            str(SB_SWEEP_EPOCHS), "--select-gen-seeds", SB_SELECT_SEEDS, "--band-eval-top", "1",
            "--band-gen-seeds", SB_BAND_SEEDS, "--data-root", ep_root, "--device", str(dev),
            "--out", sweep_file], "seed_sweep")
        times["seed_sweep"] = time.perf_counter() - t0
        with open(sweep_file) as f:
            if json.load(f) != doc:
                fail("seed_sweep's --out differs from its line")
        # jsonable writes a -inf margin (a non-finite mean) as null
        rows = [dict(r, worst_margin=float("-inf") if r["worst_margin"] is None
                     else r["worst_margin"]) for r in doc["ranked"]]
        ident = ("train_seed", "epochs", "lr", "kld_weight", "point_mode")
        if [[r[i] for i in ident] for r in seed_sweep.rank_candidates(rows)] != \
                [[r[i] for i in ident] for r in rows] or len(rows) != 2 or \
                len(doc["band_eval"]) != 1:
            fail(f"seed_sweep's ranking is not rank_candidates on its rows: {doc['ranked']}")
        info["seed_sweep"] = {
            "ranked": [{k: r[k] for k in (*ident, "beats_published", "worst_margin", "means",
                                          "final_loss")} for r in doc["ranked"]],
            "band_eval": doc["band_eval"]}

        # ---- multiseed_validate on sce2: chunked, stopped and resumed, one call
        def band_run(tag, chunk):
            return driver_line(multiseed_validate.main, [
                "--scenarios", "sce2", "--gen-seeds", SB_BAND_GENS, "--data-root", ep_root,
                "--ckpt-root", ckpt_root, "--chunk", str(chunk), "--device", str(dev),
                "--out", os.path.join(work, f"band_{tag}.json")], "multiseed_validate")

        class Stopped(Exception):
            pass

        t0 = time.perf_counter()
        chunked = band_run("chunked", SB_CHUNK)
        times["multiseed_chunked"] = time.perf_counter() - t0
        real, calls = multiseed_validate.generate_and_track_multi, []

        def stop_after_first(*args, **kwargs):
            if calls:
                raise Stopped
            calls.append(kwargs["seeds"])
            return real(*args, **kwargs)

        multiseed_validate.generate_and_track_multi = stop_after_first
        try:
            band_run("resumed", SB_CHUNK)
            fail("the interrupted multiseed_validate run did not stop")
        except Stopped:
            pass
        finally:
            multiseed_validate.generate_and_track_multi = real
        with open(os.path.join(work, "band_resumed.json.progress")) as f:
            saved = sorted(json.load(f)["sce2"]["reports"])
        t0 = time.perf_counter()
        resumed = band_run("resumed", SB_CHUNK)
        times["multiseed_resumed"] = time.perf_counter() - t0
        if resumed["sce2"] != chunked["sce2"]:
            fail("the resumed band differs from the uninterrupted chunked run")
        t0 = time.perf_counter()
        single = band_run("single", 0)
        times["multiseed_single"] = time.perf_counter() - t0
        gap = {m: {"max_abs": max(abs(a - b) for a, b in zip(
                       chunked["sce2"][m]["values"], single["sce2"][m]["values"])),
                   "band_std": single["sce2"][m]["std"]}
               for m in multiseed_validate.METRICS}
        info["multiseed_validate"] = {
            "gen_seeds": SB_BAND_GENS, "chunk": SB_CHUNK, "saved_before_stop": saved,
            "resumed_bit_for_bit": True, "chunked_vs_single": gap,
            "gap_exceeds_spread": [m for m, g in gap.items() if g["max_abs"] > g["band_std"]],
            "band": {m: {k: single["sce2"][m][k] for k in ("mean", "std")}
                     for m in multiseed_validate.METRICS}}

        # ---- stage_timings: pipeline_sce2, K2 at 4 x 300, the DNDA stage
        ft._fused_multi_call.launches = 0
        t0 = time.perf_counter()
        stages = driver_line(stage_timings.main, [
            "--data-root", ep_root, "--sut-dir", sut_dir, "--ckpt-root", ckpt_root,
            "--scenarios", "sce2", "--epochs", str(SB_K2_EPOCHS), "--processes", "1",
            "--device", str(dev)], "stage_timings")
        times["stage_timings"] = time.perf_counter() - t0
        k2_launches = ft._fused_multi_call.launches
        n_sut = len([f for f in os.listdir(sut_dir) if f.endswith(".csv")])
        want = {"pipeline_sce2", "sce2_conditions", "sce2_generate", "sce2_track",
                "sce2_validate", f"multi_kernel_train_4x{SB_K2_EPOCHS}",
                f"dnda_sweep_{n_sut}_episodes"}
        if set(stages) != want or (dev.type == "cuda" and k2_launches != 2):
            fail(f"stage_timings gave stages {sorted(stages)} (expected {sorted(want)}) and "
                 f"{k2_launches} K2 launches (expected 2)")
        info["stage_timings"] = {k: v["seconds"] for k, v in stages.items()}

        # ---- dnda_drift_probe at one rep; its stages against score_directory
        t0 = time.perf_counter()
        drift = driver_line(dnda_drift_probe.main, [
            "--sut-dir", sut_dir, "--reps", str(SB_DRIFT_REPS), "--processes", "1",
            "--device", str(dev)], "dnda_drift_probe")
        frames = dnda_drift_probe._smoke(sut_dir, dev)
        times["dnda_drift_probe"] = time.perf_counter() - t0
        info["dnda_drift_probe"] = {"summary": drift["summary"], "reps": drift["reps"],
                                    "frames_matched": frames}
    info.update(depth={"sweep_seeds": SB_SWEEP_SEEDS, "sweep_epochs": SB_SWEEP_EPOCHS,
                       "select_gen_seeds": SB_SELECT_SEEDS, "band_seeds": SB_BAND_SEEDS,
                       "band_gens": SB_BAND_GENS, "chunk": SB_CHUNK,
                       "stage_scenarios": ["sce2"], "k2_epochs": SB_K2_EPOCHS,
                       "drift_reps": SB_DRIFT_REPS},
                driver_s=times, k2_launches=k2_launches, budget_s=SB_BUDGET_S, card=card)
    return info, k2_launches


def edges_phase(np, torch, dev, w4, ep_root, card):
    """The migration and control edges on the card: ``.pth`` export and
    import, the optimizer state's round trip, the horizon sweep, the linear
    MPC, and ``cli.py doctor``."""
    import io

    from defensive_model_vae_tpu_torch import cli, scenarios
    from defensive_model_vae_tpu_torch.control import sine_road_demo, sweep_horizons
    from defensive_model_vae_tpu_torch.models import CVAEConfig
    from defensive_model_vae_tpu_torch.train import (TrainConfig, load_checkpoint,
                                                     load_opt_state, save_checkpoint,
                                                     save_opt_state, train)
    from defensive_model_vae_tpu_torch.train.torch_import import (export_to_pth,
                                                                  import_to_checkpoint)

    info = {}
    ckpts = os.path.join(HERE, "results", "checkpoints")
    with tempfile.TemporaryDirectory() as work:
        # .pth: export sce1, import it back from an offset-mode file name
        t0 = time.perf_counter()
        pth = os.path.join(work, "vae_offset_sce1_ld8_epoch3000.pth")
        export_to_pth(os.path.join(ckpts, "sce1"), pth)
        back = import_to_checkpoint(pth, os.path.join(work, "imported"), device=dev)
        p0, cfg0, _ = load_checkpoint(os.path.join(ckpts, "sce1"), dev)
        p1, cfg1, m1 = load_checkpoint(back, dev)
        if cfg1 != cfg0 or set(p1) != set(p0) or not all(
                torch.equal(p1[k][n], p0[k][n]) for k in p0 for n in ("w", "b")):
            fail("sce1 exported to .pth and imported back differs from the checkpoint")
        if m1["scenario"] != "sce1" or m1["offset_mode"] is not True:
            fail(f"the imported manifest reads {m1['scenario']!r}, offset_mode "
                 f"{m1['offset_mode']!r} from {os.path.basename(pth)}")
        info["pth"] = {"seconds": time.perf_counter() - t0, "scenario": m1["scenario"],
                       "offset_mode": m1["offset_mode"], "params": "bit for bit"}

        # the optimizer state: two halves through opt_state.npz, one long run
        t0 = time.perf_counter()
        half = TrainConfig(epochs=EDGE_OPT_EPOCHS)
        pa, ha, sa = train(w4, train_cfg=half, return_state=True, device=dev)
        d = os.path.join(work, "resume")
        save_checkpoint(d, pa, CVAEConfig(), "sce4", ha)
        save_opt_state(d, sa)
        pb, _, _ = load_checkpoint(d, dev)
        pc, hc = train(w4, train_cfg=half, init_state=(pb, load_opt_state(d, pb)),
                       start_epoch=EDGE_OPT_EPOCHS, device=dev)
        pf, hf = train(w4, train_cfg=TrainConfig(epochs=2 * EDGE_OPT_EPOCHS), device=dev)
        same = all(np.array_equal(np.concatenate([ha[k], hc[k]]), hf[k]) for k in hf) \
            and all(torch.equal(pc[k][n], pf[k][n]) for k in pf for n in ("w", "b"))
        info["opt_state"] = {"seconds": time.perf_counter() - t0,
                             "epochs": [EDGE_OPT_EPOCHS, EDGE_OPT_EPOCHS], "bit_for_bit": same}
        if not same:
            fail("training resumed through opt_state.npz differs from one run")

    # the horizon sweep on sce1's window 1
    w1 = np.load(scenarios.get("sce1").fixture_windows)
    wp = w1[1][:, [1, 2, 0]].astype(float)
    wp[0, 2] = 0.0
    v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
    init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
    t0 = time.perf_counter()
    res = sweep_horizons(wp, init, combos=EDGE_SWEEP["combos"], dt=EDGE_SWEEP["dt"],
                         device=dev)
    info["sweep"] = {"seconds": time.perf_counter() - t0,
                     "rows": [dataclasses.asdict(r) for r in res]}
    if len(res) != len(EDGE_SWEEP["combos"]) or not all(
            np.isfinite(r.max_error) and r.mean_error < EDGE_SWEEP["mean_m"] for r in res):
        fail(f"the horizon sweep is off the path: {info['sweep']}")

    # the linear MPC's sine road, on the card and on the CPU
    t0 = time.perf_counter()
    ref, st, ctl = sine_road_demo(EDGE_SINE["steps"], device=dev)
    card_s = time.perf_counter() - t0
    _, st_cpu, _ = sine_road_demo(EDGE_SINE["steps"], device="cpu")
    road = max(float(np.hypot(ref[:, 0] - p[0], ref[:, 1] - p[1]).min())
               for p in st[EDGE_SINE["settle"]:])
    vs_cpu = float(np.abs(st - st_cpu).max())
    info["linear_mpc"] = {"seconds": card_s, "steps": EDGE_SINE["steps"],
                          "road_max_m": road, "end_speed": float(st[-1, 2]),
                          "states_vs_cpu": vs_cpu, "limits": EDGE_SINE}
    if not (np.all(np.abs(ctl[:, 0]) <= 1.0 + 1e-6)
            and np.all(np.abs(ctl[:, 1]) <= np.deg2rad(45) + 1e-6)
            and road < EDGE_SINE["road_m"] and st[-1, 2] > EDGE_SINE["end_speed"]
            and vs_cpu <= EDGE_SINE["card_vs_cpu"]):
        fail(f"the linear MPC misses the sine road: {info['linear_mpc']}")

    # cli.py doctor, in this process
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["doctor", "--ckpt-root", ckpts, "--data-root", ep_root])
            rc = 0
        except SystemExit as e:
            rc = e.code
    rows = buf.getvalue().splitlines()
    info["doctor"] = {"seconds": time.perf_counter() - t0, "rc": rc, "rows": rows}
    if rc != 0:
        fail(f"cli.py doctor exited {rc}: {rows}")
    info["card"] = card
    return info


def main() -> int:
    t_start = time.perf_counter()
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
    from defensive_model_vae_tpu_torch.ops import lu_solve as lus
    from defensive_model_vae_tpu_torch.ops import mpc_step as mst
    from defensive_model_vae_tpu_torch.ops import scale_ablation as sa
    from defensive_model_vae_tpu_torch.scripts import cache_probe
    from defensive_model_vae_tpu_torch.scripts import noise_consumer_probe as ncp
    from defensive_model_vae_tpu_torch.scripts import k1_digest as k1d
    from defensive_model_vae_tpu_torch.scripts import k1_phases as k1p
    from defensive_model_vae_tpu_torch.scripts import k3_digest as k3d
    from defensive_model_vae_tpu_torch.scripts import k3_order_noise as k3on
    from defensive_model_vae_tpu_torch.scripts import scale_ablation as sab
    from defensive_model_vae_tpu_torch.scripts import sol_checks as solc
    from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus
    from defensive_model_vae_tpu_torch.parallel import start_world
    from defensive_model_vae_tpu_torch.data import build_dataset, collect_csv_files, csv_io
    from defensive_model_vae_tpu_torch.pipeline import (
        _csv_trace_name, _draw_valid_samples, csv_starts, default_mpc_cfg, fixture_starts,
        generate_and_track_from_starts, generate_and_track_multi_from_starts, run_scenario)
    from defensive_model_vae_tpu_torch.scripts import episodes
    from defensive_model_vae_tpu_torch.utils import StageTimer
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

    # ---- 2. build, then the cache probe's rounds of nvcc start -----------
    # Every kernel of the port builds, all side by side on the host's cores;
    # then P3 is compiled in round B's directory, launched and held against
    # its plain version (the decoy), and the probe's rounds start.  They run
    # beside the phases that follow, cache_probe.SLOTS nvccs at a time, and
    # are collected at the end (phase 3).
    # (not "probe": train_scale uses that name for its own)
    nvcc_probe = cache_probe.Probe(timeout=CACHE_PROBE_ROUND_S, slots=cache_probe.SLOTS)
    atexit.register(nvcc_probe.close)  # a failed phase leaves no nvcc running
    # torch.profiler's first session in a process starts up for 8-13 s
    # (CUPTI): open and close one in a thread beside the build, so that the
    # serve phase's profile does not wait on it
    global PROFILER_WARM
    PROFILER_WARM = start_profiler_warm_up(torch, dev)
    with phase("build", 240) as info:
        t_build = time.perf_counter()
        built = _build.build_all()
        for name, b in built.items():
            ptxas = [ln.strip() for ln in b["log"].splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln
                     or "wgmma" in ln]
            info[name] = {"seconds": b["seconds"], "nvcc_s": b["nvcc_s"],
                          "cached": b["cached"], "ptxas": ptxas}
            _build.load(name)
        # the LU kernel's register form holds its rows in registers: no
        # instance may spill; its object's nvcc seconds beside K1's
        lu_spills = [ln for ln in info["lu_solve"]["ptxas"]
                     if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        if lu_spills:
            fail(f"the LU kernel spills: {lu_spills}")
        info["lu_nvcc_s"] = sum(info["lu_solve"]["nvcc_s"].values())
        info["k1_nvcc_s"] = max(info["fused_trainer"]["nvcc_s"].values(), default=None)
        # K3's and K4's bf16 weight gradients on the tensor cores (HMMA)
        # and their manual bf16 step products on wgmma (HGMMA); P1-sol's
        # products on wgmma (HGMMA); P1-stream/abl's, on FMA, counted
        # beside them
        sass_mma = {name: _build.tensor_core_ops(_build._lib_path(name))
                    for name in ("fused_scale", "scale_ablation", "p1_sol")}
        info["sass_mma"] = sass_mma
        if not sass_mma["fused_scale"]["HMMA"]:
            fail(f"K3/K4's weight gradients are not on the tensor cores: {sass_mma}")
        if not sass_mma["fused_scale"]["HGMMA"]:
            fail(f"K3/K4's step products are not on wgmma: {sass_mma}")
        if not sass_mma["p1_sol"]["HGMMA"]:
            fail(f"P1-sol's library holds no HGMMA: {sass_mma}")
        info["build_s"] = time.perf_counter() - t_build
        cdy.decoy.launches = 0
        p3_check = nvcc_probe.decoy(dev)
        p3_launches = cdy.decoy.launches
        nvcc_probe.start()

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
        lus.reset_launches(dev)
        mst.reset_launches(dev)
        graphs0 = tracker_graph_counts()
        t0 = time.perf_counter()
        traces, idx = generate_and_track_from_starts(params, cfg, starts, inits,
                                                     seed=0, mpc_cfg=mpc)
        info["generate_and_track_s"] = time.perf_counter() - t0
        # the LU kernel's runs on the main path, as the kernel counts them on
        # the card: lm_iters solves in each replayed step and in the eager
        # step that each capture runs first
        lu_launches = lus.launches(dev)
        lu_by_form = {f: lus.launches(dev, f) for f in lus.FORMS}
        mpc_launches = {kn: mst.launches(dev, kn) for kn in mst.KERNELS}
        lu_form = lus.instance(2 * mpc.control_horizon)[0]
        captured, replayed = (b - a for a, b in zip(graphs0, tracker_graph_counts()))
        lu_expected = (replayed + captured) * mpc.lm_iters
        if not replayed or lu_launches != lu_expected or lu_by_form[lu_form] != lu_expected:
            fail(f"the tracker's main path ran the LU kernel {lu_by_form} times, "
                 f"expected {lu_expected} of its {lu_form} form ({replayed} replayed "
                 f"steps, {captured} captures, {mpc.lm_iters} solves a step)")
        if set(mpc_launches.values()) != {lu_expected}:
            fail(f"the tracker's main path ran the step kernels {mpc_launches} times, "
                 f"expected {lu_expected} each")
        if len(traces) != int(ok.sum()):
            fail("tracked fewer paths than valid samples")
        steps = check_tracked(traces, mpc, "sce4")
        info.update(n_tracked=len(traces), tracked_steps=steps, lu_launches=lu_launches,
                    lu_launches_by_form=lu_by_form, mpc_step_launches=mpc_launches,
                    lu_expected=lu_expected, replayed_steps=replayed, captures=captured)
        checks, lu_row, mpc_row = tracker_checks(np, torch, dev, card)
        info.update(checks)

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

    # ---- 8. data: the committed corpora as episode CSVs and back ------------
    episodes_dir = tempfile.TemporaryDirectory()
    atexit.register(episodes_dir.cleanup)
    ep_root = episodes_dir.name
    with phase("data", 60) as info:
        t0 = time.perf_counter()
        info["loader"] = csv_io.build().name
        info["loader_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trees = episodes.write_fixture_trees(ep_root)
        info["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for key in scenarios.keys():
            got = build_dataset(ep_root, key)
            want = np.load(scenarios.get(key).fixture_windows)
            if got.dtype != want.dtype or got.shape != want.shape or \
                    got.tobytes() != want.tobytes():
                fail(f"build_dataset on {key}'s episodes differs from its fixture")
            info[key] = {"episodes": len(trees[key]), "windows": len(got)}
        info["build_dataset_s"] = time.perf_counter() - t0
        # the loader alone (no parse cache): every episode once
        rows = 0
        t0 = time.perf_counter()
        for paths in trees.values():
            for path in paths:
                rows += len(csv_io.read_csv_native(path)[1])
        parse_s = time.perf_counter() - t0
        info.update(rows_parsed=rows, parse_s=parse_s, rows_per_s=rows / parse_s,
                    card=card)

    # ---- 9. pipeline: run_scenario on sce2 from the episodes ----------------
    with phase("pipeline", 60) as info, tempfile.TemporaryDirectory() as out_dir:
        sce2 = scenarios.get("sce2")
        ckpt = os.path.join(HERE, "results", "checkpoints", "sce2")
        timer = StageTimer(dev)
        t0 = time.perf_counter()
        report = run_scenario(ckpt, "sce2", ep_root, out_dir, seed=0, device=dev,
                              timer=timer)
        info["run_scenario_s"] = time.perf_counter() - t0
        info["stages_s"] = {k: v["seconds"] for k, v in timer.report().items()}
        # the same program on the same inputs: the starts and initial states
        # get_start_conditions reads, the from-starts path, the same seed
        p2, cfg2, manifest2 = load_checkpoint(ckpt, dev)
        csvs = collect_csv_files(os.path.join(ep_root, sce2.town))
        starts2, inits2 = csv_starts(sce2, csvs)
        shift = manifest2.get("offset_mode", True)
        _, ok2 = _draw_valid_samples(p2, cfg2, starts2, 0, shift)
        ref, idx = generate_and_track_from_starts(p2, cfg2, starts2, inits2, seed=0,
                                                  mpc_cfg=default_mpc_cfg(sce2),
                                                  shift_start=shift)
        names = [_csv_trace_name("sce2", csvs[b]) for b in idx]
        gen_dir = os.path.join(out_dir, "GeneratedData")
        saved = sorted(f for f in os.listdir(gen_dir) if f.endswith(".npy"))
        if len(idx) != int(ok2.sum()) or report["n_tracked"] != len(idx):
            fail("run_scenario tracked another count than the valid samples")
        if len(set(names)) != len(names) or saved != sorted(names):
            fail(f"run_scenario's trace names are not one unique file a trace: {saved}")
        for name, tr in zip(names, ref):
            got = np.load(os.path.join(gen_dir, name))
            if not np.all(np.isfinite(got)):
                fail(f"non-finite trace {name}")
            if got.dtype != tr.dtype or got.shape != tr.shape or \
                    got.tobytes() != tr.tobytes():
                fail(f"{name} differs from generate_and_track_from_starts on the same starts")
        with open(os.path.join(out_dir, "validation_sce2.json")) as f:
            saved_report = json.load(f)
        metrics = {k: v for k, v in saved_report.items() if k != "provenance"}
        if any(v is None or not np.isfinite(v) for v in metrics.values()):
            fail(f"validation_sce2.json holds a non-finite metric: {metrics}")
        if metrics["n_human"] != len(csvs) or len(csvs) != 16:
            fail(f"validation over {metrics['n_human']} human tracks of {len(csvs)} episodes")
        info.update(metrics=metrics, n_valid=int(ok2.sum()), card=card)

    # ---- 10. dnda: SUT risk scoring, the collision sweep on the card ---------
    sut_work = tempfile.TemporaryDirectory()  # the SUT episodes, for the scoreboard phase
    atexit.register(sut_work.cleanup)
    with phase("dnda", 30) as info:
        info.update(dnda_phase(np, torch, dev, trees, card, sut_work.name))

    # ---- 11. K3 and K4 against their plain versions ------------------------
    # a block takes ceil(steps / SMs) 32-row steps: one in the 4096- and
    # 1000-row cases, five (and a short last chunk) in the 20,000-row one,
    # 32 at the bench shape (phase 12)
    with phase("k3_vs_plain", 90) as info:
        rows = []
        # K4, and one epoch of K3, on the order-free case
        # (scripts/k3_order_noise.py) in both dtypes: K4's gradients and loss
        # row, K3's params and loss row, bit for bit the plain version's, and
        # the plain version that leaves a 32-row step out unequal
        for cd in (None, "bfloat16"):
            xp, xpk, xnv = k3on.exact_case(dev, cd)
            wrong = xpk.clone()
            wrong[k3on.EXACT_DROP, cfg.seq_len * cfg.dim + cfg.cond_dim] = 0  # mask
            for name, kernel, plain, compare in (
                    ("K4", k3on.exact_kernel, k3on.exact_plain, k3on.exact_row),
                    ("K3", k3on.exact_k3_kernel, k3on.exact_k3_plain, k3on.exact_k3_row)):
                row, ok = compare(kernel(xp, xpk, xnv, cd), plain(xp, xpk, xnv, cd))
                _, wrong_equal = compare(kernel(xp, xpk, xnv, cd), plain(xp, wrong, xnv, cd))
                row.update(kernel=name, case="order_free", dtype=cd or "float32",
                           rows=k3on.EXACT_ROWS, tile=k3on.EXACT_TILE,
                           wrong_step_equal=wrong_equal)
                rows.append(row)
                emit({"k3_vs_plain": row})
                if not ok:
                    fail(f"{name} differs from its plain version on the order-free case: "
                         f"{row}")
                if wrong_equal:
                    fail(f"the order-free case passes a plain version without a step: {row}")
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

    # ---- 12. train_scale: the production-scale path at the bench shape -----
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

    # ---- 13. K2 and the seed grid against their plain versions ------------
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

    # ---- 14. multi: every scenario's model in one K2 launch ---------------
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
        # each scenario's model sampled and tracked at every start with its
        # own tracker
        tracked, seed0_traces = {}, {}
        for k in keys:
            sce = scenarios.get(k)
            starts_k, inits_k = fixture_starts(corpora[k])
            mpc_k = default_mpc_cfg(sce)
            gen_k, ok_k = _draw_valid_samples(mparams[k], cfg, starts_k, seed=0)
            if not np.all(np.isfinite(gen_k)) or not ok_k.any():
                fail(f"the {k} model drew non-finite samples or no valid one")
            t0 = time.perf_counter()
            traces_k, idx_k = generate_and_track_from_starts(
                mparams[k], cfg, starts_k, inits_k, seed=0, mpc_cfg=mpc_k)
            if not len(traces_k):
                fail(f"no valid sample of the {k} model")
            tracked[k] = {"n_starts": len(starts_k), "n_valid": int(ok_k.sum()),
                          "n_tracked": len(traces_k),
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

    # ---- 15. track_multi: several generation seeds in one tracking batch --
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

    # ---- 16. seeds: the seed sweep in one launch of K1 on 32 blocks -------
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

    # ---- 17. the K3 ablation's kernels against their plain versions --------
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
        w_in, w_ch = solc.chip_weights(packed.shape[1], dev)
        # P1-sol: the order-free case bit for bit, the corpus within the
        # plain version's own order spread
        sol_exact = solc.exact_case(dev, n_chain)
        row, ok, caught = solc.check(sa.p1_sol, packed, w_in, w_ch, n_chain, ABL_TILE, 3,
                                     sol_exact)
        row = {"kernel": "P1-sol", "n": ABL_N, "epochs": 3, **row}
        rows.append(row)
        emit({"ablation_vs_plain": row})
        if not ok:
            fail(f"P1-sol disagrees with its plain version: {row}")
        if not caught:
            fail(f"P1-sol's checks pass a wrong plain version: {row}")
        for mode in ("stream", "fwd", "dx"):
            wrong = {}
            if mode == "stream":
                k, p = sa.p1_stream(packed, 3, ABL_TILE), sa._p1_stream_plain(packed, 3, ABL_TILE)
                scale = float(packed.float().abs().sum())
            else:
                k = sa.p1_ablation(packed, plist, mode, cfg, lw, float(nv), 3, ABL_TILE)
                p = sa._p1_ablation_plain(packed, plist, mode, cfg, lw, float(nv), 3)
                scale = float(sa._dx_plain(packed, plist, cfg, lw, float(nv)).float().abs().sum())
            if mode == "dx":
                wrong = p1_wrong_sums(sa, ft, packed, plist, cfg, lw, float(nv))
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

    # ---- 18. ablation: the ported K3 ablation at the bench width -----------
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
        if abl_cuda["stream"] != abl_launches["p1_stream"]:
            fail(f"P1-stream issued {abl_cuda['stream']} CUDA launches for "
                 f"{abl_launches['p1_stream']} calls (one a call)")
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
        w_in, w_ch = solc.chip_weights(packed.shape[1], dev)
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
            if mode == "sol":
                res, ok, caught = solc.check(sa.p1_sol, packed, w_in, w_ch, n_chain,
                                             SCALE_TILE, E, sol_exact)
                err = res["order"]["sum_gap"]
                emit({"ablation": {"kernel": "P1-sol", "n": SCALE_N, "epochs": E, **res}})
            elif mode == "fwd":
                err = float((k[:, :5] - p[:, :5]).abs().max())
                ok, caught = (float(((k[:, :5] - p[:, :5]).abs() / p[:, :5].abs()).max())
                              <= P1_TOL["fwd_rel"]), True
            else:
                terms = (float(packed.float().abs().sum()) if mode == "stream" else
                         float(sa._dx_plain(packed, plist, cfg, lw, float(nv)).float().abs().sum()))
                wrong = ({} if mode == "stream" else
                         p1_wrong_sums(sa, ft, packed, plist, cfg, lw, float(nv)))
                res, ok, caught = p1_sum_row(mode, k, p, terms, wrong)
                err = res["sum_gap"]
            if not ok:
                fail(f"P1-{mode} disagrees with its plain version at the bench width: "
                     f"{err} {res}")
            if not caught:
                fail(f"P1-{mode}'s limit passes a wrong plain version at the bench width: {res}")
            p1_res[mode] = {"max_abs_err": err, "plain_ms": p1_plain_ms * scale_up,
                            "ms": 1e3 * out["variants"][mode]["best_s"], **res}
        # P1-stream (one launch for the ABL_EPOCHS epochs) in turns with its
        # library call, ABL_EPOCHS torch.sum calls: through the wrapper, and
        # on the device alone (the window behind a spin kernel)
        def s_call():
            return sa.p1_stream(packed, ABL_EPOCHS, SCALE_TILE)

        def s_lib():
            return [torch.sum(packed, dtype=torch.float32) for _ in range(ABL_EPOCHS)]

        s_call(), s_lib()  # warm
        s_med, s_spread = in_turns(lambda: cuda_ms(s_call)[0], lambda: cuda_ms(s_lib)[0])
        s_dev, s_dev_spread = in_turns(lambda: device_ms(s_call, 1),
                                       lambda: device_ms(s_lib, 1))
        p1_res["stream"].update(
            ablation_best_ms=p1_res["stream"]["ms"], ms=s_med["kernel"],
            device_ms=s_dev["kernel"], library_ms=s_med["library"],
            library_device_ms=s_dev["library"],
            spread={"ms": s_spread["kernel"], "device_ms": s_dev_spread["kernel"],
                    "library_ms": s_spread["library"],
                    "library_device_ms": s_dev_spread["library"]})
        p1_res["sol"].update(sol_library_turns(torch, sa, packed, w_in, w_ch, n_chain))
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

    # ---- 19. train_auto: K1's autodiff instance on the main path ---------
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

    # ---- 20. auto_vs_plain: the autodiff instances against their plain versions
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

    # ---- 21. train_scale_auto: the CLI's --backward auto at the bench shape
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

    # ---- 22. scan_bf16: the scan trainer's bf16 chain and its siblings -----
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

    # ---- 23. conv: BASELINE config 3, the Conv1D VAE, on the card ------------
    with phase("conv", 120) as info:
        info.update(conv_phase(np, torch, dev, card))

    # the parallel phase's gloo world of two starts here: its ranks' start-up
    # (7-11 s of importing torch and joining the group, PR 16) runs beside
    # the edges, k1_digest and serve phases, off the card, and they wait,
    # idle, for the phase's call
    gloo_world = start_world(2, "gloo", dev.type, timeout_s=PAR_WORLD_S)

    # ---- 24. edges: .pth, optimizer state, horizon sweep, linear MPC, doctor --
    with phase("edges", 120) as info:
        info.update(edges_phase(np, torch, dev, w4, ep_root, card))

    # ---- 25. k1_digest: the K1 family bit for bit the one-block build ---------
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

    # ---- 26. serve: the four committed models behind one HTTP endpoint -------
    with phase("serve", 150) as info:
        serve_info = serve_phase(np, torch, dev, w4, card)
        info.update(serve_info)

    # ---- 27. parallel: the data-parallel tier over torch.distributed ---------
    with phase("parallel", PAR_BUDGET_S) as info:
        info.update(parallel_phase(np, torch, dev, ws, w4, card, gloo_world))
    k4_dp_launches = info["dp_launches"]

    # ---- 28. drivers: the research drivers at full width, cut depth ---------
    with phase("drivers", DRV_BUDGET_S) as info:
        drv, k2_opt_err = drivers_phase(np, torch, dev, corpora, cfg, lw, card)
        info.update(drv)
    drv_launches = drv["launches"]
    grid_us = {v: {"us_per_epoch_seed": r["us_per_epoch_seed"], "cluster": r["cluster"]}
               for v, r in drv["grid_probe"]["variants"].items()}

    # ---- 30. scoreboard: reproduce_scoreboard and the last four drivers -------
    with phase("scoreboard", SB_BUDGET_S) as info:
        sb, k2_sb_launches = scoreboard_phase(np, torch, dev, ep_root,
                                              os.path.join(sut_work.name, "score"), card)
        info.update(sb)

    # ---- 3. cache_probe: the rounds' verdicts, and P3 timed ---------------
    # (run last: the probe's nvccs, started after the build, finish beside
    # the phases since, and P3's host timing wants a quiet host)
    with phase("cache_probe", 90) as info:
        cp = nvcc_probe.finish()
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

    # ---- 29. kernels --------------------------------------------------------
    emit({"check_s": time.perf_counter() - t_start, "card": card})
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
    sol_src = f"{PKG}/csrc/p1_sol.cu"
    pf = p1_flops(cfg)
    width41 = width + cfg.latent_dim
    corpus_bytes = ABL_EPOCHS * SCALE_N * width41 * 2
    p1_rows = []
    for name, mode, line, p1_ops, extra_bytes, lib_note in (
            ("p1_stream", "stream", 182, ABL_EPOCHS * SCALE_N * width41, 0, None),
            ("p1_sol", "sol", 148, ABL_EPOCHS * SCALE_N * pf["sol"], 2 * (width41 + 128) * 128,
             None),
            ("p1_ablation_fwd", "fwd", 94, ABL_EPOCHS * SCALE_N * pf["fwd"],
             4 * cfg.n_params(), "no single PyTorch call: the CVAE's forward and loss"),
            ("p1_ablation_dx", "dx", 94, ABL_EPOCHS * SCALE_N * pf["dx"], 4 * cfg.n_params(),
             "no single PyTorch call: the forward and the gradient in x")):
        b_ms, b_by = bound(p1_ops, corpus_bytes + extra_bytes + 4 * 8 * ABL_EPOCHS,
                           FP32_FLOPS if mode == "stream" else BF16_FLOPS)
        p1_rows.append({
            "name": name, "route": "cuda", "source": sol_src if mode == "sol" else abl_src,
            "replaces": f"scripts/scale_ablation.py:{line}",
            "launches": abl_launches[name], "cuda_launches": abl_cuda[mode],
            "max_abs_err": p1_res[mode]["max_abs_err"], "ms": p1_res[mode]["ms"],
            "plain_ms": p1_res[mode]["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": p1_res[mode].get("library_ms"),
            **({"library_note": lib_note} if lib_note else {}),
            **({"fp32_fma_bound_ms": 1e3 * p1_ops / FP32_FLOPS} if mode != "stream" else {}),
            **({k: p1_res[mode][k] for k in ("turns_ms", "spread", "library_call")}
               if mode == "sol" else {}),
            **({k: p1_res[mode][k] for k in ("device_ms", "library_device_ms", "spread",
                                             "ablation_best_ms")}
               if mode == "stream" else {}),
            **({"library_call": f"{ABL_EPOCHS} x torch.sum(packed, dtype=torch.float32)",
                "device_bound_share": b_ms / p1_res[mode]["device_ms"]}
               if mode == "stream" else {}),
            **({"sass_mma": sass_mma["p1_sol"]} if mode == "sol" else {}),
            "bound_share": b_ms / p1_res[mode]["ms"],
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
             {"epochs": ABL_EPOCHS, "max_abs_err_epochs": ABL_PLAIN_EPOCHS,
              "drivers_launches": drv_launches["hot_probe"]["k3_dwT"]}),
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
        # the drivers phase: grid_probe's single_x32 and run_baseline_configs
        "drivers_launches": (drv_launches["grid_probe"]["k1"]
                             + drv_launches["run_baseline_configs"]["k1"]),
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
        # the drivers phase (grid_probe, run_baseline_configs): every K2
        # launch, those under _metrics="static" and those of use_mask=False
        "drivers_launches": (drv_launches["grid_probe"]["k2"]
                             + drv_launches["run_baseline_configs"]["k2"]),
        # the scoreboard phase: stage_timings' warm and timed 4 x 300 runs
        "scoreboard_launches": k2_sb_launches,
        "static_launches": drv_launches["grid_probe"]["k2_static"],
        "unmasked_launches": drv_launches["grid_probe"]["k2_unmasked"],
        # use_mask=False on the four corpora padded to 134 rows, 50 epochs
        "options_max_abs_err": k2_opt_err,
        "grid_probe": grid_us,
        "grid_probe_epochs": DRV_GRID_EPOCHS,
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
        # hot_probe in the drivers phase (its dwT launches among them)
        "drivers_launches": drv_launches["hot_probe"]["k3"],
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
        # its launches on the parallel phase's dp tier (a NCCL world of one)
        "dp_launches": k4_dp_launches,
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
    }] + auto_rows + [{
        "name": "lu_solve",
        "route": "cuda",
        "source": f"{PKG}/csrc/lu_solve.cu",
        "replaces": "none: jnp.linalg.solve in the jitted tracker, "
                    "defensive_model_vae_tpu/control/mpc.py:172 (XLA)",
        "launches": lu_launches,
        "launches_by_form": lu_by_form,
        **lu_row,
        "library_call": "torch.linalg.solve_ex (the plain version)",
        "bound_share": lu_row["bound_ms"] / lu_row["device_ms"],
        "card": card,
    }, {
        "name": "mpc_step",
        "route": "cuda",
        "source": f"{PKG}/csrc/mpc_step.cu",
        "replaces": "none: JAX's tracker step is plain XLA, "
                    "defensive_model_vae_tpu/control/mpc.py:141-222",
        # form and update on track's main path; the serve request's
        "launches": mpc_launches,
        "serve_launches": serve_info["mpc_step_launches"],
        **mpc_row,
        "plain": "control/mpc.py::_simulate_eager (the torch step)",
        "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
