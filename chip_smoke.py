#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its name and seconds, each under
a watchdog (``faulthandler.dump_traceback_later``) that turns a hang into a
traceback and a non-zero exit:

1. ``device``      torch, CUDA, the card, ``nvidia-smi``, ``nvcc``, triton;
2. ``build``       ``nvcc`` builds every kernel of the port, all at once;
3. ``k1_vs_plain`` kernel K1 against its plain torch version on the card
                   (explicit ε, sce2 B=16 and sce4 B=134, 1 and 50 epochs);
4. ``train``       the main path: ``fused_train`` on sce4 at full width
                   (134 windows, H=128, 3000 epochs) in one K1 launch, its
                   time against the plain version's, a checkpoint round trip;
5. ``sample``      one trajectory per sce4 start point, with re-draws;
6. ``track``       the samples tracked by the batched MPC, and the SLSQP
                   golden windows held to the bands of tests/test_mpc.py;
7. ``k3_vs_plain`` kernels K3 and K4 against their plain torch versions on
                   the card (f32 and bf16, packed, hbm and prng noise, ragged
                   corpora, blocks of one 32-row step and of several);
8. ``train_scale`` the production-scale path at the bench shape:
                   ``fused_train_scale`` on 131,072 windows, 200 epochs, tile
                   2048, bf16, hbm noise, in one K3 call; K3's time against
                   the plain version's, and K3 held against it over the
                   first 10 epochs; a float32 run; a per-epoch
                   ``fused_train_scale_dp`` run through K4; K4 timed and held
                   against its plain version; a checkpoint round trip;
9. ``k2_vs_plain`` kernel K2 against its plain (padded and masked) torch
                   version on the card: the four fixture corpora, explicit ε,
                   1 and 50 epochs; and K1 on a grid of 4 seeds against K1's
                   plain version once per seed;
10. ``multi``      the path that trains every scenario's model:
                   ``fused_train_multi`` on the four corpora at 3000 epochs
                   in one K2 launch, each scenario converging (last <
                   first/5); K2 timed against its plain version; at 300
                   epochs each scenario held against ``fused_train`` with
                   seed + i; each model sampled and tracked with its
                   scenario's tracker, controls within bounds;
11. ``track_multi`` ``generate_and_track_multi_from_starts`` with 4
                   generation seeds on the sce2 model, row by row against
                   per-seed ``generate_and_track_from_starts``;
12. ``seeds``      the seed sweep: ``fused_train_seeds`` on sce4, 32 seeds ×
                   3000 epochs in one launch of K1 on 32 blocks, every seed
                   converging; timed against the plain version; at 300
                   epochs 4 seeds bit for bit against ``fused_train``;
13. ``kernels``    one line listing every ported kernel with its launches on
                   its main path, its error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the port beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
# K4 (one epoch's summed gradients): each array to a fraction of its own max
# (float32: summation order; bf16: JAX's own bf16 rule), the loss row relative
K4_TOL = {None: {"grad_rel_max": 1e-5, "row_rel": 1e-5},
          "bfloat16": {"grad_rel_max": 1e-2, "row_rel": 1e-4}}

# the seed sweep of bench.py::bench_seed_grid (:718): 32 seeds of sce4 at
# the reference depth; the plain versions of K1, K2 and the seed grid are
# timed over these epochs (and seeds) on the same inputs and scaled up to the
# kernels' work, which is linear in both
SWEEP_SEEDS, DEPTH = 32, 3000
PLAIN_K1_EPOCHS, PLAIN_MULTI_EPOCHS, PLAIN_SEEDS, PLAIN_SEEDS_EPOCHS = 300, 100, 2, 100
# the bit-for-bit and per-scenario checks of K2 and the seed grid
CHECK_EPOCHS, CHECK_SEEDS = 300, (0, 9, 22, 31)

# the bench shape of the production-scale trainer (bench.py::bench_scale_fused)
SCALE_N, SCALE_EPOCHS, SCALE_TILE = 131072, 200, 2048
PLAIN_BUDGET_S = 30.0   # the plain version runs the full 200 epochs if it fits
PROBE_EPOCHS = 10       # else these, scaled up; K3 is held against them


def scale_corpus(n, seq_len=10, dim=3):
    """Synthetic production-scale corpus with reference-like coordinate
    scales — a copy of ``bench.py::_scale_corpus`` (:346), seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.5, 2.2, (n, seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal([[-193.0, 50.0]], [[1.0, 20.0]], (n, seq_len, dim - 1)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


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


def scale_flops_bytes(cfg, n, epochs, adam, itemsize, width):
    """K3's (adam) or K4's work from this run's shapes: the products (and
    Adam's ~10 operations per parameter an epoch); the bytes of the corpus
    and the ε stream, each read once, and the params (in and out) or
    gradients and the metrics."""
    n_params = cfg.n_params()
    flops = epochs * (n * window_epoch_flops(cfg) + (10 * n_params if adam else 0))
    nbytes = (itemsize * n * (width + epochs * cfg.latent_dim)
              + 4 * (2 * n_params + 8 * epochs))
    return flops, nbytes


def bound(flops, nbytes, peak):
    """(bound ms, what bounds it) for work of ``flops`` at ``peak`` FLOP/s
    moving ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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

    from defensive_model_vae_tpu_torch import scenarios
    from defensive_model_vae_tpu_torch._device import resolve_device
    from defensive_model_vae_tpu_torch.control import MPCConfig, track_batch
    from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
    from defensive_model_vae_tpu_torch.ops import _build
    from defensive_model_vae_tpu_torch.ops import fused_scale as fs
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.pipeline import (
        _draw_valid_samples, default_mpc_cfg, fixture_starts,
        generate_and_track_from_starts, generate_and_track_multi_from_starts)
    from defensive_model_vae_tpu_torch.train import load_checkpoint, save_checkpoint

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

    # ---- 2. build ---------------------------------------------------------
    with phase("build", 240) as info:
        built = _build.build_all()
        for name, b in built.items():
            ptxas = [ln.strip() for ln in b["log"].splitlines()
                     if "registers" in ln or "spill" in ln or "entry function" in ln]
            info[name] = {"seconds": b["seconds"], "cached": b["cached"], "ptxas": ptxas}
            _build.load(name)

    # ---- 3. K1 against its plain version ----------------------------------
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

    # ---- 4. train: the main path ------------------------------------------
    w4 = np.load(scenarios.get("sce4").fixture_windows)
    epochs = 3000
    with phase("train", 360) as info:
        ft.fused_call.launches = 0
        t0 = time.perf_counter()
        params, hist = ft.fused_train(w4, epochs=epochs, lr=1e-3, weights=lw,
                                      seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ft.fused_call.launches
        if launches != 1:
            fail(f"fused_train launched K1 {launches} times, expected 1")
        tot = hist["total"]
        if not np.all(np.isfinite(np.stack(list(hist.values())))):
            fail("non-finite training metrics")
        if not tot[-1] < tot[0]:
            fail(f"loss did not descend: {tot[0]} -> {tot[-1]}")
        # times on the same inputs: the kernel (median of 3), the plain version
        x, c = ft.fused_inputs(w4, dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        kernel_ms, _ = cuda_ms(lambda: ft.fused_call(plist, x, c, 0, cfg, lw, epochs,
                                                     1e-3), 3)
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
        info.update(epochs=epochs, B=len(w4), launches=launches, main_path_s=wall,
                    loss_first=float(tot[0]), loss_last=float(tot[-1]),
                    kernel_ms=kernel_ms, plain_ms=plain_ms,
                    plain_epochs_timed=PLAIN_K1_EPOCHS, card=card)

    # ---- 5. sample ----------------------------------------------------------
    starts, inits = fixture_starts(w4)
    with phase("sample", 60) as info:
        gen, ok = _draw_valid_samples(params, cfg, starts, seed=0)
        if not np.all(np.isfinite(gen)):
            fail("non-finite samples")
        info.update(n_starts=len(starts), n_valid=int(ok.sum()))
        if not ok.any():
            fail("no valid sample")

    # ---- 6. track -----------------------------------------------------------
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


    # ---- 7. K3 and K4 against their plain versions ------------------------
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

    # ---- 8. train_scale: the production-scale path at the bench shape -----
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
        # times on the same inputs: K3 (median of 3), its plain version
        nv, packed = fs._scale_inputs(ws, cfg, SCALE_TILE, "bfloat16", None, dev)
        n_pad = packed.shape[0]
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        eps_all = fs.hbm_noise(0, SCALE_EPOCHS, n_pad, cfg.latent_dim, "bfloat16", dev)
        args = (plist, packed, 0, cfg, lw, SCALE_EPOCHS, 1e-3, SCALE_TILE, float(nv),
                "bfloat16", "hbm", eps_all)
        k3_ms, _ = cuda_ms(lambda: fs._fused_scale_call(*args), 3)
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

    # ---- 9. K2 and the seed grid against their plain versions ------------
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

    # ---- 10. multi: every scenario's model in one K2 launch ---------------
    with phase("multi", 300) as info:
        ft._fused_multi_call.launches = 0
        t0 = time.perf_counter()
        mparams, mhist = ft.fused_train_multi(corpora, epochs=DEPTH, seed=0, device=dev)
        torch.cuda.synchronize()
        multi_wall = time.perf_counter() - t0
        k2_launches = ft._fused_multi_call.launches
        if k2_launches != 1:
            fail(f"fused_train_multi launched K2 {k2_launches} times, expected 1")
        losses = converged(mhist, "fused_train_multi")
        # K2 and its plain version on the main path's inputs
        st, x, c, off = ragged(range(len(keys)))
        k2_ms, _ = cuda_ms(lambda: ft._fused_multi_call(st, x, c, off, range(len(keys)), cfg,
                                                        lw, DEPTH, 1e-3))
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
        info.update(epochs=DEPTH, rows=off, k2_launches=k2_launches, main_path_s=multi_wall,
                    losses=losses, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
                    plain_epochs_timed=PLAIN_MULTI_EPOCHS, vs_fused_train_max_abs=gap,
                    tracked=tracked, card=card)

    # ---- 11. track_multi: several generation seeds in one tracking batch --
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

    # ---- 12. seeds: the seed sweep in one launch of K1 on 32 blocks -------
    with phase("seeds", 300) as info:
        sweep = list(range(SWEEP_SEEDS))
        ft._fused_seeds_call.launches = 0
        t0 = time.perf_counter()
        _, swhist = ft.fused_train_seeds(w4, sweep, epochs=DEPTH, device=dev)
        torch.cuda.synchronize()
        seeds_wall = time.perf_counter() - t0
        seeds_launches = ft._fused_seeds_call.launches
        if seeds_launches != 1:
            fail(f"fused_train_seeds launched {seeds_launches} times, expected 1")
        losses = converged(swhist, "fused_train_seeds")
        x4, c4 = ft.fused_inputs(w4, dev)
        st = ft.stack_flat_params([init_params(torch.Generator().manual_seed(q), cfg, dev)
                                   for q in sweep])
        seeds_ms, _ = cuda_ms(lambda: ft._fused_seeds_call(st, x4, c4, sweep, cfg, lw, DEPTH,
                                                           1e-3))
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
        info.update(seeds=SWEEP_SEEDS, epochs=DEPTH, B=len(w4), launches=seeds_launches,
                    main_path_s=seeds_wall, kernel_ms=seeds_ms, plain_ms=seeds_plain_ms,
                    plain_timed=[PLAIN_SEEDS, PLAIN_SEEDS_EPOCHS],
                    bit_identical_seeds=list(CHECK_SEEDS), check_epochs=CHECK_EPOCHS,
                    loss_first_max=max(v[0] for v in losses.values()),
                    loss_last_max=max(v[1] for v in losses.values()), card=card)

    # ---- 13. kernels --------------------------------------------------------
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
    # a block runs on one SM: the largest run alone at one SM's share
    one_sm_ms = 1e3 * grid_flops_bytes(cfg, [max(k2_rows)], 0, DEPTH)[0] / (FP32_FLOPS / 132)
    emit({"kernels": [{
        "name": "k1_fused_trainer",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:326",
        "launches": launches,
        "max_abs_err": k1_err["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES_S else "bytes",
        "library_ms": None,
        "one_sm_bound_ms": bound_ms * 132,
        "flops": flops,
        "card": card,
    }, {
        "name": "k1_fused_trainer_seed_grid",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:326",
        "launches": seeds_launches,
        "blocks": SWEEP_SEEDS,
        # the 4-seed grid against its plain version, 50 epochs, explicit ε
        "max_abs_err": seeds_err["max_abs_err"],
        "ms": seeds_ms,
        "plain_ms": seeds_plain_ms,
        "bound_ms": sw_bound,
        "bound_by": sw_by,
        "library_ms": None,
        "one_sm_per_block_bound_ms": one_sm_ms,
        "flops": sw_flops,
        "card": card,
    }, {
        "name": "k2_fused_train_multi",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_trainer.cu",
        "replaces": "defensive_model_vae_tpu/ops/fused_trainer.py:454",
        "launches": k2_launches,
        "blocks": len(keys),
        # the four corpora against the plain version, 50 epochs, explicit ε
        "max_abs_err": k2_err["max_abs_err"],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
        "one_sm_largest_block_bound_ms": one_sm_ms,
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
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
        "fp32_fma_bound_ms": 1e3 * k4_flops / FP32_FLOPS,
        "flops": k4_flops,
        "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
