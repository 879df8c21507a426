"""Command-line interface of the port: ``dataset``, ``train [--fused |
--fused-scale]``, ``generate``, ``pipeline``, ``validate``, ``thw``,
``serve``, ``dnda``, ``dnda-sweep``, ``metrics``, ``writeback``,
``mpc-sweep``, ``import``, ``export`` and ``doctor``.

Run as ``python -m defensive_model_vae_tpu_torch.cli``; mirrors the JAX
package's ``defvae`` commands of the same names (cli.py:692, :712-770, :775,
:803, :809-831, :846, :864-871, :902-936) with their arguments, and writes
the same checkpoint manifest ``recipe``:

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
    python -m defensive_model_vae_tpu_torch.cli writeback \
        --npy results/GeneratedData/tracked_trajectory_sce1_exp11_3.npy \
        --data-root DefensiveData --out-dir sut/
    python -m defensive_model_vae_tpu_torch.cli dnda --scenario sce1 \
        --csv sut/DEF_StaticBlindTown05_1.csv [--host] [--out-csv f.csv]
    python -m defensive_model_vae_tpu_torch.cli dnda-sweep --dir sut/ \
        --out max_dnda_summary.csv [--host] [--processes 4]
    python -m defensive_model_vae_tpu_torch.cli metrics --scenario sce1 \
        --csv sut/DEF_StaticBlindTown05_1.csv --metric PET
    python -m defensive_model_vae_tpu_torch.cli mpc-sweep --waypoints wps.npy \
        --initial-state "[-190.0, 20.0, 1.5708, 0.0, 10.0]" --combos 10:5,20:10
    python -m defensive_model_vae_tpu_torch.cli import \
        --pth vae_offset_sce1_ld8_epoch3000.pth --ckpt ckpt/
    python -m defensive_model_vae_tpu_torch.cli export --ckpt ckpt/ --pth model.pth
    python -m defensive_model_vae_tpu_torch.cli doctor [--no-device]

``--fused-scale`` is the production-scale trainer (kernel K3; with
``--mesh``, the per-epoch tier through kernel K4, on one device until the
data-parallel slice); ``--backward auto`` runs its autodiff instance.
Without ``--fused``/``--fused-scale``, ``--dtype bfloat16`` runs the scan
trainer's bf16 chain.  A command that touches the device takes
``--device``, default ``cuda``; ``--device cpu`` runs on the CPU (the
kernels' plain versions).  ``doctor`` checks the environment: the card, the
kernel build cache and nvcc, the g++-built native libraries, the data and
the checkpoints; it exits 1 on any FAIL.  ``dnda`` and ``dnda-sweep`` run the collision
sweep on the card by default; ``--host`` runs the numpy oracle path.  JSON
output writes non-finite metrics as ``null``.
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


def _cmd_dnda(args):
    """DNDA of one SUT episode (JAX cli.py:253): per frame, and the maximum."""
    from .dnda import process_episode
    from .utils import jsonable

    res = process_episode(args.csv, args.scenario, max_frames=args.max_frames,
                          device=args.device, host=args.host)
    if args.out_csv:
        # per-frame CSV like the reference driver's per-file output
        # (DNDA_calculator.py:352-361)
        import csv

        with open(args.out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["frame", "dnda"])
            w.writerows(zip(res.frames, res.dnda))
    print(json.dumps(jsonable({"frames": res.frames, "dnda": res.dnda,
                               "max_dnda": res.max_dnda})))


def _cmd_dnda_sweep(args):
    """Every SUT episode of a directory scored (JAX cli.py:276)."""
    from .dnda import score_directory
    from .utils import jsonable

    rows = score_directory(args.dir, out_csv=args.out, processes=args.processes,
                           device=args.device, host=args.host)
    print(json.dumps(jsonable(rows), indent=2))


def _cmd_metrics(args):
    """TTC, PET or JERK over one SUT episode (JAX cli.py:504)."""
    from .metrics import compute_metric
    from .utils import jsonable

    out = compute_metric(args.csv, args.scenario, args.metric)
    col = args.metric.strip().upper()
    finite = out[col][np.isfinite(out[col])]
    print(json.dumps(jsonable({
        "metric": col,
        "rows": len(out),
        "valid": int(len(finite)),
        "mean": float(np.mean(finite)) if len(finite) else None,
        "min": float(np.min(finite)) if len(finite) else None,
        "max": float(np.max(finite)) if len(finite) else None,
    })))


def _cmd_writeback(args):
    """A tracked trace written into its source episode (JAX cli.py:539)."""
    from .sut import writeback_npy_to_csv

    out = writeback_npy_to_csv(args.npy, args.data_root, args.out_dir)
    print(f"saved {out}")


def _cmd_mpc_sweep(args):
    """Prediction/control-horizon study (JAX cli.py:382)."""
    from .control.sweep import sweep_horizons

    wps = np.load(args.waypoints)
    init = np.asarray(json.loads(args.initial_state), float)
    combos = [tuple(map(int, c.split(":"))) for c in args.combos.split(",")]
    results = sweep_horizons(wps, init, combos=combos, dt=args.dt, device=args.device)
    print(json.dumps([{"P": r.prediction_horizon, "M": r.control_horizon,
                       "max_error_m": round(r.max_error, 4),
                       "mean_error_m": round(r.mean_error, 4),
                       "final_error_m": round(r.final_error, 4)} for r in results],
                     indent=2))


def _cmd_import(args):
    """A reference ``.pth`` into a checkpoint directory (JAX cli.py:525)."""
    from .train.torch_import import import_to_checkpoint

    d = import_to_checkpoint(args.pth, args.ckpt, dim=args.dim, device=args.device)
    print(f"imported {args.pth} -> {d}")


def _cmd_export(args):
    """A checkpoint directory into a reference ``.pth`` (JAX cli.py:532)."""
    from .train.torch_import import export_to_pth

    out = export_to_pth(args.ckpt, args.pth)
    print(f"exported {args.ckpt} -> {out}")


def _cmd_doctor(args):
    """Environment check (JAX cli.py:546): the card, the kernel build
    cache, the native libraries, the data and the checkpoints.  Exit 1 on
    any FAIL; a WARN is a state the port works in (no CARLA corpus, say).

    JAX's rows map to the port's: its backend to ``torch.cuda``'s device
    name and count; its jit probe to a small sum on the card; its
    compilation cache to ``ops/_build.py``'s ``build/`` (writable, ``nvcc``
    found, the libraries of the current sources built); its native loader
    and DNDA kernels to their g++ builds (``_native.py``), which have no
    fallback here.  JAX's hash-seed row has no counterpart: the port's build
    key is a digest of file contents, the same in every process.  With
    ``--no-device`` (a host-only check) a missing card or ``nvcc`` is a
    WARN, else a FAIL."""
    import torch

    rows = []  # (status, name, detail)

    def check(name, fn, warn_only=False):
        try:
            rows.append(("ok", name, fn() or ""))
        except Exception as e:  # a row reports its failure; the exit code carries it
            rows.append(("WARN" if warn_only else "FAIL", name, f"{type(e).__name__}: {e}"))

    def _backend():
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is False)")
        return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"

    check("cuda backend", _backend, warn_only=args.no_device)

    def _probe():
        if args.no_device:
            return "skipped (--no-device)"
        v = float(torch.arange(8.0, device="cuda").sum())
        if v != 28.0:
            raise RuntimeError(f"sum of 0..7 on the card is {v}")
        return "launch + copy back ok"

    check("device probe", _probe)

    def _build_dir():
        from .ops import _build

        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if not os.access(_build.BUILD_DIR, os.W_OK):
            raise RuntimeError(f"{_build.BUILD_DIR} not writable")
        return str(_build.BUILD_DIR)

    check("kernel build cache", _build_dir)

    def _kernel_libs():
        from .ops import _build

        version = _build.nvcc_version().strip().splitlines()[-1]
        built = [n for n in _build.KERNELS if _build._lib_path(n).exists()]
        return f"{version}; {len(built)}/{len(_build.KERNELS)} libraries built"

    check("nvcc and kernel libraries", _kernel_libs, warn_only=args.no_device)

    def _csvloader():
        from .data import csv_io

        return f"native C++ loader ({csv_io.build().name})"

    check("csv loader", _csvloader)

    def _spline():
        from .dnda import spline

        return f"native C++ spline/Frenet/curvature ({spline.build().name})"

    check("dnda native kernels", _spline)

    def _data():
        from . import scenarios
        from .data import collect_csv_files

        if not os.path.isdir(args.data_root):
            raise RuntimeError(f"{args.data_root} absent (fixtures still work)")
        n = sum(len(collect_csv_files(os.path.join(args.data_root, s.town)))
                for s in (scenarios.get(k) for k in scenarios.REGISTRY))
        return f"{args.data_root} ({n} episode CSVs)"

    check("raw CARLA corpus", _data, warn_only=True)

    def _fixtures():
        from . import scenarios

        missing = [k for k in scenarios.REGISTRY
                   if not os.path.exists(scenarios.get(k).fixture_windows)]
        if missing:
            raise RuntimeError(f"missing fixtures: {missing}")
        return f"{len(scenarios.REGISTRY)} scenario corpora"

    check("fixture corpora", _fixtures, warn_only=True)

    def _ckpts():
        from . import scenarios

        found = []
        for k in scenarios.REGISTRY:
            mf = os.path.join(args.ckpt_root, k, "manifest.json")
            if os.path.exists(mf):
                with open(mf) as f:
                    json.load(f)
                found.append(k)
        if not found:
            raise RuntimeError(f"no checkpoints under {args.ckpt_root}")
        return f"{len(found)}/{len(scenarios.REGISTRY)} manifests readable"

    check("checkpoints", _ckpts, warn_only=True)

    width = max(len(n) for _, n, _ in rows)
    for status, name, detail in rows:
        print(f"{status:>4}  {name:<{width}}  {detail}")
    if any(status == "FAIL" for status, _, _ in rows):
        raise SystemExit(1)


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

    dn = sub.add_parser("dnda", help="DNDA risk scoring of an episode CSV")
    dn.add_argument("--scenario", required=True)
    dn.add_argument("--csv", required=True)
    dn.add_argument("--max-frames", type=int, default=None)
    dn.add_argument("--out-csv", default=None, help="per-frame CSV path")
    dn.add_argument("--host", action="store_true",
                    help="the frame-by-frame numpy sweep (the oracle path) instead of "
                         "the batched torch sweep on --device")
    dn.add_argument("--device", default="cuda")
    dn.set_defaults(fn=_cmd_dnda)

    ds = sub.add_parser("dnda-sweep", help="score every SUT episode in a directory")
    ds.add_argument("--dir", required=True)
    ds.add_argument("--out", default=None, help="summary CSV path")
    ds.add_argument("--processes", type=int, default=None)
    ds.add_argument("--host", action="store_true",
                    help="score end to end on the host process pool (numpy sweep, the "
                         "oracle path) instead of one batched torch sweep on --device")
    ds.add_argument("--device", default="cuda")
    ds.set_defaults(fn=_cmd_dnda_sweep)

    m = sub.add_parser("metrics", help="TTC/PET/JERK on an episode CSV")
    m.add_argument("--scenario", required=True)
    m.add_argument("--csv", required=True)
    m.add_argument("--metric", default="TTC")
    m.set_defaults(fn=_cmd_metrics)

    wb = sub.add_parser("writeback", help="inject tracked npy into source CSV")
    wb.add_argument("--npy", required=True)
    wb.add_argument("--data-root", required=True)
    wb.add_argument("--out-dir", required=True)
    wb.set_defaults(fn=_cmd_writeback)

    ms_ = sub.add_parser("mpc-sweep", help="prediction/control-horizon study")
    ms_.add_argument("--waypoints", required=True, help="(N,3) [x,y,t] npy")
    ms_.add_argument("--initial-state", required=True,
                     help='JSON "[x, y, theta, vx, vy]"')
    ms_.add_argument("--combos", default="10:5,20:10,30:20,40:30",
                     help="comma-separated P:M pairs")
    ms_.add_argument("--dt", type=float, default=0.02)
    ms_.add_argument("--device", default="cuda")
    ms_.set_defaults(fn=_cmd_mpc_sweep)

    im = sub.add_parser("import", help="convert a reference .pth checkpoint")
    im.add_argument("--pth", required=True)
    im.add_argument("--ckpt", required=True)
    im.add_argument("--dim", type=int, default=None,
                    help="trajectory dim when ambiguous (a dim=2 model whose "
                         "2*seq_len divides by 3 defaults to dim=3)")
    im.add_argument("--device", default="cuda")
    im.set_defaults(fn=_cmd_import)

    ex = sub.add_parser("export", help="convert a native checkpoint to a reference .pth")
    ex.add_argument("--ckpt", required=True, help="checkpoint directory")
    ex.add_argument("--pth", required=True, help="output .pth path")
    ex.set_defaults(fn=_cmd_export)

    dr = sub.add_parser("doctor", help="environment health check (card, kernel build "
                                       "cache, native libs, data, checkpoints)")
    dr.add_argument("--data-root", default="DefensiveData")
    dr.add_argument("--ckpt-root", default="results/checkpoints")
    dr.add_argument("--no-device", action="store_true",
                    help="skip the card probe (host-only check)")
    dr.set_defaults(fn=_cmd_doctor)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
