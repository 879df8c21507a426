"""Where the K1 family's time goes, by the kernels' phase timer:

    python -m defensive_model_vae_tpu_torch.scripts.k1_phases [--epochs 3000]

Runs K1 and K1-auto on sce4, K2 (and K2-auto) on the four fixture corpora
and the seed grid (and the grid under auto) of 32 seeds on sce4, each
once with the optional timer buffer (``ops/fused_trainer.py::phase_timer``):
the first CTA of run 0 reads ``%globaltimer`` at each phase's end, before
and after its barrier, so the split is that CTA's view, summed over the
epochs, with the barrier waits apart.  Each launch is also timed by CUDA
events.  ``--untimed`` times the launches alone, without the timer or a
cluster size, which an earlier build's entries also take.  Prints one
JSON line per kernel.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_trainer as ft
from .k1_digest import SCENARIOS, _windows


def _timed(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


KERNELS = ("k1", "k1_auto", "k2", "k2_auto", "grid", "grid_auto")


def split(dev, kernel, epochs, seeds=32, cluster=0, timed=True):
    """(CUDA-event ms of one launch, its phase split, the cluster size
    taken) for ``kernel`` in :data:`KERNELS`; with ``timed=False`` the
    launch alone, (ms, None, None)."""
    cfg, lw = CVAEConfig(), LossWeights()
    timer = ft.phase_timer(dev) if timed else None
    kw = {"backward": "auto" if kernel.endswith("_auto") else "manual"}
    if timed:
        kw.update(cluster=cluster, timer=timer)
    kind = kernel.removesuffix("_auto")
    if kind == "k1":
        x, c = ft.fused_inputs(_windows("sce4"), dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        ms = _timed(lambda: ft.fused_call(plist, x, c, 0, cfg, lw, epochs, 1e-3, None, **kw))
        entry = ft.fused_call
    else:
        runs = list(range(len(SCENARIOS) if kind == "k2" else seeds))
        stacked = ft.stack_flat_params(
            [init_params(torch.Generator().manual_seed(s), cfg, dev) for s in runs])
        if kind == "k2":
            ins = [ft.fused_inputs(_windows(k), dev) for k in SCENARIOS]
            off = np.concatenate([[0], np.cumsum([len(a) for a, _ in ins])]).tolist()
            x = torch.cat([a for a, _ in ins]).contiguous()
            c = torch.cat([b for _, b in ins]).contiguous()
            ms = _timed(lambda: ft._fused_multi_call(stacked, x, c, off, runs, cfg, lw,
                                                     epochs, 1e-3, **kw))
            entry = ft._fused_multi_call
        else:
            x, c = ft.fused_inputs(_windows("sce4"), dev)
            ms = _timed(lambda: ft._fused_seeds_call(stacked, x, c, runs, cfg, lw, epochs,
                                                     1e-3, **kw))
            entry = ft._fused_seeds_call
    if not timed:
        return ms, None, None
    return ms, ft.phase_split(timer), entry.cluster


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS), choices=KERNELS)
    ap.add_argument("--untimed", action="store_true",
                    help="the launches alone: no phase timer, no cluster size")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
    for k in args.kernels:
        ms, phases, taken = split(dev, k, args.epochs, cluster=args.cluster,
                                  timed=not args.untimed)
        print(json.dumps({"kernel": k, "epochs": args.epochs, "ms": ms, "cluster": taken,
                          "phases_ms": phases, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
