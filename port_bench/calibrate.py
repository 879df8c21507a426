"""Readings that the limits of ``correct`` are set from.

    python3 -m port_bench.calibrate --workload <cell> --seeds 11 12 13 ...
        [--faults half_batch ...] [--seconds 0]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (0: one unit of work), then the numbers compared for the
program, for the control (the reference in the program's place, one
precision below the configuration's) and for each planted fault.  One JSON
line a seed; every number is a reading, none is judged here.
"""

from __future__ import annotations

import argparse
import json
import sys

from port_bench import manifest as mf
from port_bench.run import Context, apply_precision, set_cache_env
from port_bench.trace import Tracer


def readings(m, cell: str, seed: int, seconds: float, faults, device: str,
             traffic_override=None) -> dict:
    w, config, traffic = mf.cell(m, cell)
    traffic = {**traffic, **(traffic_override or {})}
    apply_precision(config)
    drv = mf.driver(traffic["driver"])(Context(w, config, traffic, seed, device,
                                               Tracer(False)))
    drv.setup()
    drv.window(seconds)
    drv.release()
    def values(outputs=None):
        got = {c["name"]: c["value"] for c in drv.check(outputs)}
        if hasattr(drv, "detail"):  # the training cells' readings beside them
            got.update(drv.detail(outputs))
        return got

    out = {"seed": seed, "program": values(), "control": values(drv.control_outputs())}
    for f in faults:
        out[f] = values(drv.fault_outputs(f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    set_cache_env()
    m = mf.load()
    for seed in args.seeds:
        print(json.dumps(readings(m, args.workload, seed, args.seconds, args.faults,
                                  args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
