"""SHA-256 digests of the K1 family's results on fixed seeded cases, to hold
K1, K1-auto, K2 and the seed grid bit for bit against an earlier build:

    python -m defensive_model_vae_tpu_torch.scripts.k1_digest [--cluster N]

Each case trains from ``init_params`` of a fixed seed on the committed
fixture corpora and hashes the bytes of every result array in order (the
final params, then the (E, 8) or (S, E, 8) metrics).  ``REFERENCE`` holds
the digests of the one-block-per-run build (commit 99c62e2), taken on an
NVIDIA H100 80GB HBM3 (132 SMs) with CUDA 12.8; the cluster build computes
every sum in that build's order, so it must give the same bytes at every
cluster size.  ``--cluster`` forces the launches' cluster size (0 picks).
Prints one JSON line and exits non-zero when a digest differs, or when the
card's SM count has no reference.  Runs on the card unless ``--device
cpu`` (the plain versions' digests, which no reference holds; ``--cases``
keeps that short).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_trainer as ft

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "fixtures"
SCENARIOS = ("sce1", "sce2", "sce3", "sce4")
# name: (entry, backward, epochs, noise); K1's cases on sce4 (134 windows),
# K2's on the four fixture corpora (seeds 0-3), the grid's 4 seeds of sce4
CASES = {
    "k1_manual_e50": ("k1", "manual", 50, "philox"),
    "k1_manual_e3000": ("k1", "manual", 3000, "philox"),
    "k1_auto_e50": ("k1", "auto", 50, "philox"),
    "k1_auto_e3000": ("k1", "auto", 3000, "philox"),
    "k1_manual_e50_eps": ("k1", "manual", 50, "eps"),
    "k2_manual_e50": ("k2", "manual", 50, "philox"),
    "grid_manual_e50": ("grid", "manual", 50, "philox"),
}
# {SM count: {case: digest}}: the build at commit 99c62e2 on an NVIDIA H100
# 80GB HBM3 (132 SMs), CUDA 12.8
REFERENCE = {132: {
    "k1_manual_e50": "27e870cc11d6419a5f70f2f25c5c3e24472e8f1a3a386ba7e2b999bcf9674654",
    "k1_manual_e3000": "3bf8c0e24d62aa12dd58248aa6c1ca0da59ca5b50da1478697a1e9f9007df8b1",
    "k1_auto_e50": "19b509e607666697c8235f07eddcfbc0ec5e17eb91a682dea661c24ac42d3482",
    "k1_auto_e3000": "8dd13e08518115d8605bc412a0ecd9585cade3e25fa04de649205a991e336e06",
    "k1_manual_e50_eps": "0a1f23ee36db624964c180864fcd8aee50a79a55ab318a48684bf9ac3dae8d51",
    "k2_manual_e50": "9f52b03e6e7e000ac237670629b14cca6e7e84b17e9a5534eb3d2b074b51a2f4",
    "grid_manual_e50": "a7a6c3eda81adf31d139d10979eed264b51300a60e171f3ac2ab6eb532c093b6",
}}


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _windows(sce):
    return np.load(FIXTURES / f"trajectory_{sce}_cond.npy")


def run_case(name, dev, cluster=None):
    """One case's (params, metrics); ``cluster`` goes to the launch when
    given (None keeps the entries' own signature, so the script also runs
    on a build whose entries take no cluster size)."""
    entry, backward, epochs, noise = CASES[name]
    cfg, lw = CVAEConfig(), LossWeights()
    kw = {"backward": backward}
    if cluster is not None:
        kw["cluster"] = cluster
    if entry == "k1":
        w = _windows("sce4")
        x, c = ft.fused_inputs(w, dev)
        plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        eps = None
        if noise == "eps":
            eps = torch.as_tensor(np.random.default_rng(9).standard_normal(
                (len(w), cfg.latent_dim)).astype(np.float32)).to(dev)
        return ft.fused_call(plist, x, c, 0, cfg, lw, epochs, 1e-3, eps, **kw)
    seeds = [0, 1, 2, 3]
    stacked = ft.stack_flat_params([init_params(torch.Generator().manual_seed(s), cfg, dev)
                                    for s in seeds])
    if entry == "k2":
        ins = [ft.fused_inputs(_windows(k), dev) for k in SCENARIOS]
        off = np.concatenate([[0], np.cumsum([len(a) for a, _ in ins])]).tolist()
        x = torch.cat([a for a, _ in ins]).contiguous()
        c = torch.cat([b for _, b in ins]).contiguous()
        return ft._fused_multi_call(stacked, x, c, off, seeds, cfg, lw, epochs, 1e-3, **kw)
    x, c = ft.fused_inputs(_windows("sce4"), dev)
    return ft._fused_seeds_call(stacked, x, c, seeds, cfg, lw, epochs, 1e-3, **kw)


def digests(dev, cases=None, cluster=None) -> dict:
    """{case: digest} over ``cases`` (all by default)."""
    out = {}
    for name in cases or CASES:
        params, metrics = run_case(name, dev, cluster)
        out[name] = _digest(list(params) + [metrics])
    return out


def reference(sms):
    """The reference digests for a card of ``sms`` SMs; raises for a card
    that has none."""
    if sms not in REFERENCE:
        raise ValueError(f"no K1 reference digests for a card of {sms} SMs "
                         f"(known: {sorted(REFERENCE)})")
    return REFERENCE[sms]


def mismatches(got: dict, ref: dict) -> list:
    """The cases of ``got`` whose digest is not the reference's."""
    return [k for k, v in got.items() if ref.get(k) != v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cluster", type=int, default=None,
                    help="force the launches' cluster size (0 picks)")
    ap.add_argument("--cases", nargs="*", default=None, choices=sorted(CASES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print(json.dumps({"k1_digest": digests(dev, args.cases, args.cluster),
                          "device": str(dev)}), flush=True)
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ref = reference(sms)
    got = digests(dev, args.cases, args.cluster)
    bad = mismatches(got, ref)
    print(json.dumps({"k1_digest": got, "sms": sms, "cluster": args.cluster,
                      "reference": {k: ref.get(k) for k in got}, "mismatches": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
