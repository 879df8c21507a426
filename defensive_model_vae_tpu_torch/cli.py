"""Command-line interface of the port: ``train [--fused | --fused-scale]``
and ``generate``.

Run as ``python -m defensive_model_vae_tpu_torch.cli``; mirrors the JAX
package's ``defvae train`` / ``defvae generate`` (cli.py:45-170, :711,
:766) and writes the same checkpoint manifest ``recipe``:

    python -m defensive_model_vae_tpu_torch.cli train --scenario sce4 \\
        --windows fixtures/trajectory_sce4_cond.npy --ckpt ckpt/ --fused
    python -m defensive_model_vae_tpu_torch.cli train --scenario big \\
        --windows corpus.npy --ckpt ckpt/ --fused-scale --epochs 200 \\
        --dtype bfloat16
    python -m defensive_model_vae_tpu_torch.cli generate --ckpt ckpt/ \\
        --start-x 11 --start-y 0 -n 5

``--fused-scale`` is the production-scale trainer (kernel K3; with
``--mesh``, the per-epoch tier through kernel K4, on one device until the
data-parallel slice).  ``--device`` defaults to ``cuda``; ``--device cpu``
runs on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _cmd_train(args):
    from .models import CVAEConfig, LossWeights
    from .train import TrainConfig, save_checkpoint, train

    windows = np.load(args.windows)
    weights = LossWeights(kld=args.kld)
    if args.fused and args.fused_scale:
        raise SystemExit("--fused and --fused-scale are mutually exclusive")
    if args.backward is not None and not args.fused_scale:
        raise SystemExit("--backward applies to --fused-scale only")
    if args.noise is not None and not args.fused_scale:
        raise SystemExit("--noise applies to --fused-scale only")
    if args.fused and args.mesh:
        raise SystemExit("--fused runs on one device; drop --mesh, or use "
                         "--fused-scale (the per-epoch tier)")
    if args.fused and args.dtype:
        raise SystemExit("--dtype applies to --fused-scale (the --fused kernel is "
                         "float32); drop one")
    if not (args.fused or args.fused_scale) and (args.dtype or args.mesh):
        raise SystemExit("--dtype and --mesh of the scan trainer are not ported "
                         "yet; use --fused-scale")
    noise = (args.noise or "hbm") if args.fused_scale else None
    recipe = {}
    if args.fused:
        from .ops import fused_train

        params, hist = fused_train(windows, epochs=args.epochs, lr=args.lr,
                                   weights=weights, seed=args.seed, device=args.device)
    elif args.fused_scale:
        from .ops import fused_train_scale, fused_train_scale_dp
        from .ops.fused_scale import _resolve_backward, hbm_noise_impl

        recipe = {"backward": _resolve_backward(args.backward, args.dtype, "f32_acts"),
                  "noise": noise}
        if noise == "hbm":
            recipe["noise_impl"] = hbm_noise_impl(args.device)
        trainer = fused_train_scale_dp if args.mesh else fused_train_scale
        # --dtype None keeps the CLI's pure float32 over the library's bf16
        params, hist = trainer(windows, epochs=args.epochs, lr=args.lr,
                               weights=weights, seed=args.seed, tile=args.tile,
                               compute_dtype=args.dtype, noise=noise,
                               backward=args.backward, device=args.device)
    else:
        tc = TrainConfig(epochs=args.epochs, lr=args.lr, seed=args.seed, weights=weights)
        params, hist = train(windows, train_cfg=tc, device=args.device)
    cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    save_checkpoint(
        args.ckpt, params, cfg, args.scenario, hist,
        extra_manifest={"recipe": {
            "epochs": args.epochs, "lr": args.lr, "kld_weight": args.kld,
            "seed": args.seed, "windows": os.path.basename(args.windows),
            "trainer": ("fused" if args.fused
                        else "fused-scale-dp" if args.fused_scale and args.mesh
                        else "fused-scale" if args.fused_scale else "scan"),
            **({"compute_dtype": args.dtype} if args.dtype else {}),
            **recipe,
        }},
    )
    print(f"trained {args.epochs} epochs; final loss {hist['total'][-1]:.4f}; "
          f"checkpoint at {args.ckpt}")


def _cmd_generate(args):
    from .generate import load_and_generate

    out = load_and_generate(args.ckpt, args.start_x, args.start_y, args.n,
                            args.seed, device=args.device)
    if args.out:
        np.save(args.out, out)
        print(f"saved {np.asarray(out).shape} to {args.out}")
    else:
        print(np.asarray(out))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m defensive_model_vae_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a scenario CVAE")
    t.add_argument("--scenario", required=True)
    t.add_argument("--windows", required=True)
    t.add_argument("--ckpt", required=True)
    t.add_argument("--epochs", type=int, default=3000)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--kld", type=float, default=0.1,
                   help="KLD loss weight (reference default 0.1)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--fused", action="store_true",
                   help="the whole run in one launch of kernel K1")
    t.add_argument("--fused-scale", action="store_true",
                   help="the production-scale streaming trainer (kernel K3; "
                        "with --mesh the per-epoch tier, kernel K4)")
    t.add_argument("--dtype", default=None, choices=["bfloat16"],
                   help="--fused-scale compute dtype (bf16 product operands over "
                        "float32 masters); default pure float32")
    t.add_argument("--mesh", action="store_true",
                   help="--fused-scale: the per-epoch data-parallel tier (one "
                        "device in this port so far)")
    t.add_argument("--tile", type=int, default=2048,
                   help="--fused-scale rows per tile")
    t.add_argument("--backward", choices=("auto", "manual"), default=None,
                   help="--fused-scale gradient path; the port runs 'manual' "
                        "('auto' is not ported yet)")
    t.add_argument("--noise", choices=("hbm", "prng"), default=None,
                   help="--fused-scale noise: 'hbm' (default) draws every epoch's "
                        "eps ahead of the kernel; 'prng' draws it in the kernel")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=_cmd_train)

    g = sub.add_parser("generate", help="sample trajectories from a checkpoint")
    g.add_argument("--ckpt", required=True)
    g.add_argument("--start-x", type=float, required=True)
    g.add_argument("--start-y", type=float, required=True)
    g.add_argument("-n", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out")
    g.add_argument("--device", default="cuda")
    g.set_defaults(fn=_cmd_generate)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
