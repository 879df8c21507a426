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
7. ``kernels``     one line listing every ported kernel with its launches on
                   the main path, its error, times and bound.

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

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM
FP32_FLOPS = 67e12
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
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def k1_flops_bytes(cfg, B, epochs):
    """K1's work from this run's shapes: the products of the forward, the
    weight gradients and the activation gradients (none for the inputs of
    cond_0 and enc_0), and Adam's ~10 operations per parameter; the bytes
    of x, cond, eps, the params in and out and the metrics."""
    spec = cfg.layer_spec()
    mac = sum(fi * fo for fi, fo in spec.values())
    mac_da = mac - sum(spec[n][0] * spec[n][1] for n in ("cond_0", "enc_0"))
    n_params = cfg.n_params()
    flops = epochs * (2 * B * (2 * mac + mac_da) + 10 * n_params)
    nbytes = 4 * (B * (cfg.seq_len * cfg.dim + cfg.cond_dim + cfg.latent_dim)
                  + 2 * n_params + 8 * epochs)
    return flops, nbytes


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
    from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
    from defensive_model_vae_tpu_torch.pipeline import (
        _draw_valid_samples, default_mpc_cfg, fixture_starts,
        generate_and_track_from_starts)
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
                     if "registers" in ln or "spill" in ln]
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
        kernel_ms = cuda_ms(lambda: ft.fused_call(plist, x, c, 0, cfg, lw, epochs, 1e-3), 3)
        plain_ms = cuda_ms(lambda: ft._fused_call_plain(plist, x, c, 0, cfg, lw,
                                                        epochs, 1e-3, None))
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, params, cfg, "sce4", hist)
            loaded, cfg2, _ = load_checkpoint(d, dev)
            same = all(torch.equal(loaded[k][n], params[k][n])
                       for k in params for n in ("w", "b"))
        if not same or cfg2 != cfg:
            fail("checkpoint round trip changed the params")
        info.update(epochs=epochs, B=len(w4), launches=launches, main_path_s=wall,
                    loss_first=float(tot[0]), loss_last=float(tot[-1]),
                    kernel_ms=kernel_ms, plain_ms=plain_ms, card=card)

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
        steps = 0
        for tr in traces:
            if not np.all(np.isfinite(tr)):
                fail("non-finite tracked states")
            # bounded controls, read off the states: |Δv| ≤ a_max·dt and
            # |Δθ| ≤ |v|·tan(δ_max)/L·dt
            dv = np.abs(np.diff(tr[:, 3]))
            dth = np.abs(np.diff(tr[:, 2]))
            lim = np.abs(tr[:-1, 3]) * np.tan(mpc.max_steer) / mpc.wheelbase * mpc.dt
            if dv.max() > mpc.max_accel * mpc.dt * (1 + 1e-4) or np.any(dth > lim * (1 + 1e-4) + 1e-6):
                fail("tracked states imply controls outside the bounds")
            steps += len(tr) - 1
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

    # ---- 7. kernels ---------------------------------------------------------
    flops, nbytes = k1_flops_bytes(cfg, len(w4), epochs)
    bound_ms = 1e3 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_S)
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
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
