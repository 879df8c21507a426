"""Where an epoch of the Conv1D VAE trainer goes on the card.

    python -m defensive_model_vae_tpu_torch.scripts.conv_profile \\
        [--n 256] [--seq-len 50] [--epochs 5 10] [--device cuda]

BASELINE config 3 at the shapes of ``bench.py::bench_conv_long`` (256
random-walk windows × 50 × 2, the default ``ConvCVAEConfig``): a warm-up
run, then ``train_conv`` over each of two depths under ``torch.profiler``.
The difference of the two runs is the cost of the extra epochs alone (the
set-up, the noise stream and the copy back cancel), so per epoch: the
device kernels and their busy time from the profiler, the wall time from
the host clock around runs that end in a synchronise, the host share
(1 − busy / wall), and the device kernels that take the most time.  The
products' FLOPs an epoch are counted from the shapes (the forward's
convolutions and linear layers; the backward ≈ twice the forward).  One
JSON line.  On the CPU (``--device cpu``) the profiler records no device
time, and the script says so instead of printing a device metric.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data import generate_random_trajectories
from ..models import ConvCVAEConfig
from ..models.conv_cvae import _decoder_lens
from ..train import TrainConfig, train_conv


def forward_flops(cfg: ConvCVAEConfig, n: int) -> int:
    """The forward's product FLOPs for ``n`` windows: each conv 2·N·L_out·K·
    Cin·Cout, each transposed conv 2·N·L_in·K·Cin·Cout, each linear layer
    2·N·in·out."""
    flops, L = 0, cfg.seq_len
    spec = cfg.layer_spec()
    for i in range(len(cfg.channels)):
        L = (L + 1) // 2
        K, cin, cout = spec[f"conv_{i}"]
        flops += 2 * n * L * K * cin * cout
    L = cfg.bottleneck_len
    for i, out_len in enumerate(_decoder_lens(cfg)):
        K, cin, cout = spec[f"deconv_{i}"]
        flops += 2 * n * L * K * cin * cout
        L = out_len
    for name, shape in spec.items():
        if len(shape) == 2:
            flops += 2 * n * shape[0] * shape[1]
    return flops


def _profiled(fn, torch_mod):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch_mod.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    return wall, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--epochs", type=int, nargs=2, default=(5, 10))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w = generate_random_trajectories(args.n, args.seq_len, 5.0, seed=0).astype(np.float32)
    cfg = ConvCVAEConfig(seq_len=args.seq_len, dim=w.shape[2])
    e1, e2 = args.epochs
    out = {"n": args.n, "seq_len": args.seq_len, "n_params": cfg.n_params(),
           "epochs": [e1, e2], "device": str(dev),
           "forward_gflop_per_epoch": forward_flops(cfg, args.n) / 1e9,
           "gflop_per_epoch": 3 * forward_flops(cfg, args.n) / 1e9}
    if dev.type != "cuda":
        out["profile"] = "not measured: no device time on the CPU"
        print(json.dumps(out))
        return 0
    out["card"] = torch.cuda.get_device_name(dev)
    train_conv(w, cfg, TrainConfig(epochs=e1), device=dev)  # warm-up: cuDNN's plans
    runs = [_profiled(lambda e=e: train_conv(w, cfg, TrainConfig(epochs=e), device=dev),
                      torch) for e in (e1, e2)]
    (wall1, k1), (wall2, k2) = runs
    if not k1 or not k2:
        raise RuntimeError("torch.profiler recorded no device time")
    de = e2 - e1
    busy = (sum(d for _, d in k2) - sum(d for _, d in k1)) / 1e6 / de
    wall = (wall2 - wall1) * 1e3 / de
    by_name = collections.Counter()
    for name, d in k2:
        by_name[name] += d
    out.update(kernels_per_epoch=(len(k2) - len(k1)) / de, device_busy_ms_per_epoch=busy,
               wall_ms_per_epoch=wall, host_share=1.0 - busy / wall,
               wall_s=[wall1, wall2],
               top_kernels_ms=[(name[:80], d / 1e6) for name, d in by_name.most_common(8)])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
