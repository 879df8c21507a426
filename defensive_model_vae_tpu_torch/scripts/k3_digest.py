"""SHA-256 digests of K3's and K4's results on fixed small cases, to hold
the kernels' default instances bit for bit to their reference:

    python -m defensive_model_vae_tpu_torch.scripts.k3_digest

Each case trains (K3) or takes one epoch's gradients (K4) from seeded
inputs at 8,448 rows, tiles of 352, and hashes the bytes of every result
array in order.  ``REFERENCE`` holds the digests the kernels must give:
float32's is still the build at commit d8a64ec's (every float32 output is
one FMA chain over k in order, as it was), the bf16 cases' the engine's
that runs the bf16 weight gradients on the tensor cores (their sums over a
block's rows are one product, not 32-row steps added up);
``D8A64EC_BF16`` keeps the bf16 cases of d8a64ec.  The kernels' sums are
laid out by the card's SM count, so the digests are keyed by it.  Prints one JSON line.  Runs on the card unless ``--device
cpu`` (the plain versions' digests, which no reference holds).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..ops import fused_scale as fs
from ..ops.fused_trainer import _flatten_params
from .scale_ablation import scale_corpus

N, TILE, EPOCHS = 8448, 352, 3
# name: (entry, compute dtype, noise)
CASES = {"k3_bf16_packed": ("k3", "bfloat16", "packed"),
         "k3_bf16_hbm": ("k3", "bfloat16", "hbm"),
         "k3_f32_packed": ("k3", None, "packed"),
         "k4_bf16_packed": ("k4", "bfloat16", "packed")}
# {SM count: {case: digest}} on an NVIDIA H100 80GB HBM3 (132 SMs), CUDA
# 12.8: float32 from the build at commit d8a64ec, bf16 from the engine with
# the bf16 weight gradients on the tensor cores
REFERENCE = {132: {
    "k3_bf16_packed": "4e6bcc95d6109bb87921d23d20703def0e3616c3f707268a4f9bc25063a9e83a",
    "k3_bf16_hbm": "a99218ed459feb1183af93d6dbefe3adb1d5182d3647d5dda5eceacabd881612",
    "k3_f32_packed": "f76e90a1a2ae889ababcc229fa4d53c9b74b907996c327b9faae5c7e81b3fbe1",
    "k4_bf16_packed": "3082d3539710533fceaa70e71076b9528d5507754ac8edda032a31722b6e8b2f",
}}
# the bf16 cases of the d8a64ec build, which the parent of this engine
# still gave (float32 FMA over bf16 operands, the weight gradients added
# into the partial rows step by step)
D8A64EC_BF16 = {132: {
    "k3_bf16_packed": "92291421b4e25de0d6260d741f095b0533ba8ac0196399cc72a80a12a47808af",
    "k3_bf16_hbm": "06035ebc56d117932119292b7c327ada4e780293a36d2c972b0eb63a37337d5d",
    "k4_bf16_packed": "8c62b21658395ac75ec04d7916cdfc6a426f1a664302f985696613c4eccb1b42",
}}


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def digests(dev, **kw) -> dict:
    """{case: digest} of each case's result; ``kw`` goes to K3's call
    (``_ablate=()`` for the knob-free path of the ablation)."""
    cfg, lw = CVAEConfig(), LossWeights()
    eps = np.random.default_rng(1).standard_normal((N, cfg.latent_dim)).astype(np.float32)
    out = {}
    for name, (entry, cd, noise) in CASES.items():
        nv, packed = fs._scale_inputs(scale_corpus(N, seed=3), cfg, TILE, cd,
                                      eps if noise == "packed" else None, dev)
        plist = _flatten_params(init_params(torch.Generator().manual_seed(0), cfg, dev))
        if entry == "k3":
            eps_all = (fs.hbm_noise(3, EPOCHS, packed.shape[0], cfg.latent_dim, cd, dev)
                       if noise == "hbm" else None)
            params, metrics = fs._fused_scale_call(plist, packed, 3, cfg, lw, EPOCHS, 1e-3,
                                                   TILE, float(nv), cd, noise, eps_all, **kw)
        else:
            params, metrics = fs._grad_epoch_call(plist, packed, 0, cfg, lw, TILE, float(nv),
                                                  cd, noise)
        out[name] = _digest(list(params) + [metrics])
    return out


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sms = sm_count(dev) if dev.type == "cuda" else None
    print(json.dumps({"k3_digest": digests(dev), "sms": sms,
                      "reference": REFERENCE.get(sms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
