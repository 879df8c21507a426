"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The run makes its inputs and weights from ``--seed``, builds and warms the
program (set-up, timed as ``setup_s`` from the process's start to the
window's), drives the cell's traffic for ``--seconds``, reads the card's
peak memory, frees the program's state, holds what the window produced to
the plain reference, and prints one JSON object as its last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled stretch of the
window.  It exits non-zero, printing no result, where the cards are
missing or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import manifest as mf  # noqa: E402
from port_bench.trace import Tracer  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "defensive_model_vae_tpu"}
CACHE_DIR = mf.ROOT / ".port_bench_cache"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc cache is ``defensive_model_vae_tpu_torch/build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"


class Context:
    """What a driver is given: the cell, its configuration and traffic, the
    run's seed, the device and the tracer."""

    def __init__(self, workload, config, traffic, seed, device, tracer, log=None):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.device, self.tracer = int(seed), device, tracer
        self.chips = workload["chips"]
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))


def apply_precision(config: dict) -> None:
    """The configuration's stated arithmetic: float32 products in TF32 only
    where its ``precision`` says ``tf32`` (bf16 products never use it)."""
    from port_bench.driver_base import set_tf32

    set_tf32(config["precision"] == "tf32")


def _finite(name, v):
    v = float(v)
    if not math.isfinite(v):
        raise RuntimeError(f"{name} is not finite: {v}")
    return v


def run_cell(m: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
             traffic_override: dict = None, t_start: float = None):
    """Drive one cell → (result dict, checks).  ``traffic_override``
    replaces keys of the traffic file (the tests' small sizes)."""
    w, config, traffic = mf.cell(m, cell)
    if traffic_override:
        traffic = {**traffic, **traffic_override}
    apply_precision(config)
    tracer = Tracer(trace, device)
    ctx = Context(w, config, traffic, seed, device, tracer)
    drv = mf.driver(traffic["driver"])(ctx)
    drv.setup()
    tracer.warm()
    t_window = time.monotonic()
    setup_s = t_window - (T_START if t_start is None else t_start)
    drv.window(float(seconds))
    peak = drv.memory_peak_bytes()
    attempted, failed = drv.attempted(), drv.failed()
    if trace:
        traced = tracer.result()
        if traced is None:
            raise RuntimeError("the window traced nothing")
        counters = drv.counters()
        metrics = {}
        for p in mf.per_layer_for(m, cell):
            v = mf.reader(p["name"])(traced, counters, config, traffic)
            if v is not None:
                metrics[p["name"]] = {"value": _finite(p["name"], v), "unit": p["unit"]}
        breakdown = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    else:
        e2e = dict(drv.end_to_end(), setup_s=setup_s)
        metrics = {}
        for e in mf.end_to_end_for(m, cell):
            if e["name"] not in e2e:
                raise RuntimeError(f"the driver reported no {e['name']}")
            metrics[e["name"]] = {"value": _finite(e["name"], e2e[e["name"]]), "unit": e["unit"]}
    drv.release()
    checks = drv.check()
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks) and failed == 0
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": drv.device_kind(), "count": w["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    m = mf.load()
    w, _, _ = mf.cell(m, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result, checks = run_cell(m, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for c in checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {c['name']} = {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
