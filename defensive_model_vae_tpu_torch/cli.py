"""Command-line interface of the port: ``dataset``, ``train [--fused |
--fused-scale]``, ``generate``, ``pipeline``, ``validate``, ``thw`` and
``serve``.

Run as ``python -m defensive_model_vae_tpu_torch.cli``; mirrors the JAX
package's ``defvae`` commands of the same names (cli.py:692, :712-770, :775,
:803, :846, :929) with their arguments, and writes the same checkpoint
manifest ``recipe``:

    python -m defensive_model_vae_tpu_torch.cli dataset --scenario sce2 \\
        --data-root DefensiveData --out windows.npy [--point-mode extend_mid]
    python -m defensive_model_vae_tpu_torch.cli train --scenario sce4 \\
        --windows fixtures/trajectory_sce4_cond.npy --ckpt ckpt/ --fused
    python -m defensive_model_vae_tpu_torch.cli train --scenario big \\
        --windows corpus.npy --ckpt ckpt/ --fused-scale --epochs 200 \\
        --dtype bfloat16 [--backward auto] [--noise prng]
    python -m defensive_model_vae_tpu_torch.cli generate --ckpt ckpt/ \\
        --start-x 11 --start-y 0 -n 5
    python -m defensive_model_vae_tpu_torch.cli pipeline \\
        --ckpt results/checkpoints/sce2 --scenario sce2 \\
        --data-root DefensiveData --out out/ [--trace DIR]
    python -m defensive_model_vae_tpu_torch.cli validate --scenario sce2 \\
        --tracked-dir out/GeneratedData --data-root DefensiveData
    python -m defensive_model_vae_tpu_torch.cli thw --scenario sce4 \\
        --data-root DefensiveData
    python -m defensive_model_vae_tpu_torch.cli serve \\
        --ckpt sce4=results/checkpoints/sce4 --listen 0 --batch 16

``--fused-scale`` is the production-scale trainer (kernel K3; with
``--mesh``, the per-epoch tier through kernel K4, on one device until the
data-parallel slice); ``--backward auto`` runs its autodiff instance.
Without ``--fused``/``--fused-scale``, ``--dtype bfloat16`` runs the scan
trainer's bf16 chain.  A command that touches the device takes
``--device``, default ``cuda``; ``--device cpu`` runs on the CPU (the
kernels' plain versions).  JSON output writes non-finite metrics as
``null``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _cmd_dataset(args):
    from .data import build_dataset, save_windows

    arr = build_dataset(args.data_root, args.scenario, args.points,
                        point_mode=args.point_mode, dataset_variant=args.variant)
    save_windows(arr, args.out)
    print(f"saved {arr.shape} windows to {args.out}")


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
    if not (args.fused or args.fused_scale) and args.mesh:
        raise SystemExit("--mesh of the scan trainer is not ported yet; use "
                         "--fused-scale")
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
        tc = TrainConfig(epochs=args.epochs, lr=args.lr, seed=args.seed, weights=weights,
                         compute_dtype=args.dtype)
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


def _cmd_pipeline(args):
    from .pipeline import run_scenario
    from .utils import jsonable, trace_to  # no-op context when --trace is absent

    with trace_to(args.trace):
        report = run_scenario(args.ckpt, args.scenario, args.data_root, args.out,
                              seed=args.seed, device=args.device)
    print(json.dumps(jsonable(report), indent=2))


def _cmd_validate(args):
    from . import scenarios
    from .data import collect_csv_files
    from .pipeline import load_humans, load_tracked, validate
    from .utils import jsonable

    sce = scenarios.get(args.scenario)
    tracked = load_tracked(args.tracked_dir, sce.key)
    humans = load_humans(sce, collect_csv_files(os.path.join(args.data_root, sce.town)))
    print(json.dumps(jsonable(validate(tracked, humans, sce)), indent=2))


def _cmd_thw(args):
    """Start speeds and THWs of a scenario's episodes (reference
    ``Get_THW.py``).  The histogram PNGs wait for the port's ``viz/``."""
    from . import scenarios
    from .data import collect_csv_files
    from .metrics.thw import start_velocities, thw_values
    from .utils import jsonable

    if args.out_velocity or args.out_thw:
        raise SystemExit("--out-velocity/--out-thw need viz/, which is not ported yet "
                         "(the card has no matplotlib)")
    sce = scenarios.get(args.scenario)
    sv = start_velocities(collect_csv_files(os.path.join(args.data_root, sce.town)), sce)
    report = {"start_speeds": {n: round(v, 3) for n, v in sv}}
    if sce.thw_distance is not None or sce.thw_distance_by_suffix is not None:
        report["thw"] = [round(float(t), 3) for t in thw_values(sv, sce)]
    print(json.dumps(jsonable(report), indent=2))


def _parse_ckpt_specs(specs):
    """``--ckpt`` values → ``{model_name: directory}`` (JAX cli.py:405): a
    spec is NAME=DIR iff it matches ``<simple-name>=<rest>`` with a name of
    ``[A-Za-z0-9_.-]+``; a single bare directory serves as model
    "default", and several models must all be named."""
    import re

    pat = re.compile(r"([A-Za-z0-9_.-]+)=(.+)")
    ckpts = {}
    for spec in specs:
        m = pat.fullmatch(spec)
        if m:
            name, d = m.groups()
        elif len(specs) == 1:
            name, d = "default", spec
        else:
            raise SystemExit(f"--ckpt {spec!r}: with several models each must be "
                             "NAME=DIR so requests can route by 'model'")
        if name in ckpts:
            raise SystemExit(f"duplicate model name {name!r}")
        ckpts[name] = d
    return ckpts


def _cmd_serve(args):
    """condition → sample → reference → MPC on the device (JAX cli.py:436):
    one-shot, or with ``--listen PORT`` the warm program behind a local
    HTTP endpoint (``serving.py``)."""
    if args.data_parallel:
        raise SystemExit("--data-parallel is not ported yet (ROADMAP Queue 1's "
                         "data-parallel item); serve on one device")
    if args.listen is not None:
        from .serving import serve_checkpoint

        ckpts = _parse_ckpt_specs(args.ckpt)
        server = serve_checkpoint(ckpts, args.batch, args.steps, dt=args.dt,
                                  host=args.host, port=args.listen, device=args.device)
        h, p = server.server_address[:2]
        print(f"serving {sorted(ckpts)} on http://{h}:{p} "
              f"(batch {args.batch}, steps {args.steps}); "
              f"POST /serve, POST /generate, GET /healthz", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return

    if args.start_x is None or args.start_y is None:
        raise SystemExit("--start-x/--start-y are required without --listen")
    if len(args.ckpt) != 1:
        raise SystemExit("one-shot serve takes exactly one --ckpt")
    from .serving import build_serve_fn

    (ckpt_dir,) = _parse_ckpt_specs(args.ckpt).values()
    serve = build_serve_fn(ckpt_dir, args.steps, args.dt, device=args.device)
    starts = np.tile([[args.start_x, args.start_y]], (args.batch, 1)).astype(np.float32)
    inits = np.tile([[args.start_x, args.start_y, args.heading, args.vx, args.vy]],
                    (args.batch, 1)).astype(np.float32)
    states, _ = serve(args.seed, starts, inits)
    states = states.cpu().numpy()
    if args.out:
        np.save(args.out, states)
        print(f"saved {states.shape} tracked states to {args.out}")
    else:
        print(json.dumps({"batch": args.batch, "steps": args.steps,
                          "final_xy": states[0, -1, :2].round(2).tolist(),
                          "mean_speed": round(float(states[..., 3].mean()), 2)}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m defensive_model_vae_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dataset", help="extract trajectory windows from CSVs")
    d.add_argument("--scenario", required=True)
    d.add_argument("--data-root", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--points", type=int, default=10)
    d.add_argument("--variant", choices=("shipped", "artifact"), default="shipped",
                   help="extraction predicate set: 'shipped' reproduces the reference's "
                        "npy datasets; 'artifact' uses the predicates the published "
                        "results were trained with (sce1: ego_y>=40)")
    d.add_argument("--point-mode", choices=("normal", "extend_mid"), default="normal",
                   help="'extend_mid' appends the reference's ceil-midpoint-augmented "
                        "windows to the normal ones (the sce4 checkpoint's corpus)")
    d.set_defaults(fn=_cmd_dataset)

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
                   help="compute dtype: --fused-scale's bf16 product operands over "
                        "float32 masters, or the scan trainer's bf16 chain; "
                        "default pure float32")
    t.add_argument("--mesh", action="store_true",
                   help="--fused-scale: the per-epoch data-parallel tier (one "
                        "device in this port so far)")
    t.add_argument("--tile", type=int, default=2048,
                   help="--fused-scale rows per tile")
    t.add_argument("--backward", choices=("auto", "manual"), default=None,
                   help="--fused-scale gradient path: 'manual' (the default) or "
                        "'auto' (the arithmetic of autodiff, its own kernel instance)")
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

    pl = sub.add_parser("pipeline", help="generate+track+validate a scenario")
    pl.add_argument("--ckpt", required=True)
    pl.add_argument("--scenario", required=True)
    pl.add_argument("--data-root", required=True)
    pl.add_argument("--out", required=True)
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR/trace.json "
                         "(view in Perfetto or chrome://tracing)")
    pl.add_argument("--device", default="cuda")
    pl.set_defaults(fn=_cmd_pipeline)

    v = sub.add_parser("validate", help="metric sweep over tracked traces")
    v.add_argument("--scenario", required=True)
    v.add_argument("--tracked-dir", required=True)
    v.add_argument("--data-root", required=True)
    v.set_defaults(fn=_cmd_validate)

    th = sub.add_parser("thw", help="THW / start-velocity analysis")
    th.add_argument("--scenario", required=True)
    th.add_argument("--data-root", required=True)
    th.add_argument("--out-velocity", default=None,
                    help="histogram PNG: waits for the port's viz/ (not ported yet)")
    th.add_argument("--out-thw", default=None,
                    help="histogram PNG: waits for the port's viz/ (not ported yet)")
    th.set_defaults(fn=_cmd_thw)

    from .serving import _DEFAULTS

    sv = sub.add_parser("serve", help="sample → reference → MPC, one device program")
    sv.add_argument("--data-parallel", action="store_true",
                    help="shard the request batch over devices (not ported yet)")
    sv.add_argument("--ckpt", required=True, action="append",
                    help="checkpoint directory; repeatable with --listen as NAME=DIR "
                         "to host several models")
    sv.add_argument("--start-x", type=float, default=None,
                    help="required unless --listen (requests carry their starts)")
    sv.add_argument("--start-y", type=float, default=None)
    sv.add_argument("--heading", type=float, default=_DEFAULTS["heading"])
    sv.add_argument("--vx", type=float, default=_DEFAULTS["vx"])
    sv.add_argument("--vy", type=float, default=_DEFAULTS["vy"])
    sv.add_argument("--steps", type=int, default=512)
    sv.add_argument("--batch", type=int, default=1)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--dt", type=float, default=0.02)
    sv.add_argument("--out", default=None)
    sv.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="stay up: serve requests over local HTTP (0 = an "
                         "ephemeral port) instead of the one-shot run")
    sv.add_argument("--host", default="127.0.0.1", help="bind address for --listen")
    sv.add_argument("--device", default="cuda")
    sv.set_defaults(fn=_cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
