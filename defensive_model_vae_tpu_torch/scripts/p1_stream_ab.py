"""P1-stream of two checkouts' builds, timed in turns in one process:

    python -m defensive_model_vae_tpu_torch.scripts.p1_stream_ab \\
        --a PARENT_CHECKOUT [--b CHANGE_CHECKOUT] [--rounds 6]

P1-stream's row of ``chip_smoke.py`` is the ablation's best rep of one
20-epoch call over a corpus that stays in the L2 (its earlier form: 40
small launches), whose time moves with the host's load, so
two whole ``chip_smoke.py`` runs tell little about whether a change moved
its kernels.  This script loads the
``scale_ablation`` library of each checkout (``--b`` defaults to this
package's) through that checkout's own ``ops/_build.py`` (its flags, its
C signatures, its ``build/`` directory), runs P1-stream of each on the
same bench-width corpus (131,072 windows, tile 2048, bf16, packed ε; 20
epochs a call) through the C entry that checkout has (two launches an
epoch, or one for all), checks that their metrics agree (bit for bit, or
within ``STREAM_TOL`` of the sum of |terms| where the two forms sum in
another order), and
times them in turns (a, b, b, a) ``--rounds`` times, two ways: CUDA events
around the call (host work included) and on the device alone (the window
opened behind a spin kernel).  Prints one JSON line: the median and the
(min, max) of each, and b's median over a's.  Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig
from ..ops import _build
from ..ops import fused_scale as fs
from .scale_ablation import scale_corpus

N, TILE, EPOCHS = 131072, 2048, 20
SPIN_CYCLES = 4_000_000
# two builds' sums may differ in order only: chip_smoke.py's P1_TOL["stream"]
# of the sum of |terms|
STREAM_TOL = 1e-5


def _scale_ablation_lib(checkout: pathlib.Path, tag: str):
    """``scale_ablation`` as ``checkout``'s own ``ops/_build.py`` builds and
    loads it."""
    path = checkout / "defensive_model_vae_tpu_torch" / "ops" / "_build.py"
    if path.resolve() == pathlib.Path(_build.__file__).resolve():
        return _build.load("scale_ablation")
    spec = importlib.util.spec_from_file_location(f"_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load("scale_ablation")


def _ms(fn, device_only):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first checkout's root (the parent)")
    ap.add_argument("--b", default=str(_build.PKG_ROOT.parent),
                    help="the second checkout's root (default: this package's)")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = CVAEConfig()
    eps = np.random.default_rng(7).standard_normal((N, cfg.latent_dim)).astype(np.float32)
    _, packed = fs._scale_inputs(scale_corpus(N), cfg, TILE, "bfloat16", eps, dev)
    n = packed.numel()
    terms = float(packed.float().abs().sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {k: _scale_ablation_lib(pathlib.Path(getattr(args, k)).resolve(), k)
            for k in ("a", "b")}
    metrics = {k: torch.zeros((EPOCHS, 8), device=dev) for k in libs}
    stream = torch._C._cuda_getCurrentRawStream(packed.device.index)
    calls = {}
    for k, lib in libs.items():
        if hasattr(lib, "p1_stream_grid"):  # one launch for all epochs
            grid = int(lib.p1_stream_grid(sms))
            part = torch.empty(EPOCHS * grid, device=dev)
            ticket = torch.zeros(EPOCHS, dtype=torch.int32, device=dev)
            calls[k] = (lambda lib=lib, part=part, ticket=ticket, grid=grid, k=k:
                        lib.p1_stream(packed.data_ptr(), n, EPOCHS, part.data_ptr(),
                                      ticket.data_ptr(), grid, metrics[k].data_ptr(), stream))
        else:  # the earlier form: two launches an epoch
            part = torch.empty(int(lib.sa_sum_blocks(n, sms)), device=dev)
            calls[k] = (lambda lib=lib, part=part, k=k:
                        lib.p1_stream(packed.data_ptr(), n, EPOCHS, part.data_ptr(), sms,
                                      metrics[k].data_ptr(), stream))

    def call(k):
        err = calls[k]()
        if err:
            raise RuntimeError(f"P1-stream ({k}) launch failed: CUDA error {err}")

    for k in libs:  # warm, and the results side by side
        call(k)
    torch.cuda.synchronize()
    res = {"n": N, "epochs": EPOCHS, "tile": TILE, "rounds": args.rounds,
           "device": torch.cuda.get_device_name(dev),
           "metrics_equal": torch.equal(metrics["a"], metrics["b"]),
           "metrics_gap": float((metrics["a"] - metrics["b"]).abs().max()),
           "abs_terms": terms, "tol": STREAM_TOL * terms}
    for way, device_only in (("events_ms", False), ("device_ms", True)):
        times = {"a": [], "b": []}
        for _ in range(args.rounds):
            for k in ("a", "b", "b", "a"):
                times[k].append(_ms(lambda: call(k), device_only))
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        res[way] = {k: {"median": med[k], "spread": [min(v), max(v)]}
                    for k, v in times.items()}
        res[way]["b_over_a"] = med["b"] / med["a"]
    print(json.dumps({"p1_stream_ab": res}))
    return 0 if res["metrics_gap"] <= res["tol"] else 1


if __name__ == "__main__":
    sys.exit(main())
