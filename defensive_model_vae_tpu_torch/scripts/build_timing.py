"""How long the kernels' cold build takes, and the cache probe's rounds after it.

    python -m defensive_model_vae_tpu_torch.scripts.build_timing \
        [--schedules alone,after] [--out FILE]

``chip_smoke.py`` builds every kernel of the port (``_build.build_all``:
one ``nvcc`` an object, all started together), then compiles the cache
probe's decoy and queues its three rounds of ``nvcc -cubin``
(``scripts/cache_probe.py``: three objects a round), ``cache_probe.SLOTS``
at a time, beside the phases that follow.  Each schedule here runs that
work cold, in a fresh copy of the package (its own ``build/``), and
records every nvcc's seconds from its start to its exit:

  alone   the build alone;
  after   the build, then the decoy's cubin and the probe's rounds as
          ``chip_smoke.py`` starts them (P3's library is the build's).

For each: ``build_s`` (the start to the build's last link), each build
object's and each round object's nvcc seconds, and ``probe_s`` (the start
to the last round's exit).  The schedules run one after another, in the
order given; the result is printed as one JSON line and written to
``--out`` only when given.  Needs nvcc (no card).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

from ..ops import _build
from . import cache_probe
from .mint_provenance_probe import copy_package, load_build

SCHEDULES = ("alone", "after")


def _wait(started, timeout: float):
    """Wait for a round → {object name: nvcc seconds}."""
    return {cache_probe.object_name(obj): secs
            for obj, (_, secs) in cache_probe.finish_round(started, timeout).items()}


def schedule(name: str, root: pathlib.Path, timeout: float = 600.0) -> dict:
    """One schedule, cold, in a fresh copy of the package under ``root``."""
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; one of {SCHEDULES}")
    work = root / name
    build = load_build(copy_package(work))
    t0 = time.perf_counter()
    built = build.build_all(timeout)
    out = {"schedule": name, "build_s": time.perf_counter() - t0,
           "build_nvcc_s": {lib: b["nvcc_s"] for lib, b in built.items()}}
    if name == "after":
        decoy = cache_probe.start_round([("cache_decoy", 0)], work / "B" / "decoy")
        out["decoy_nvcc_s"] = _wait(decoy, timeout)
        queue = cache_probe.Queue(cache_probe.round_jobs(work, cache_probe.objects()),
                                  cache_probe.SLOTS)
        done = queue.finish(timeout)
        out.update(slots=cache_probe.SLOTS, probe_s=time.perf_counter() - t0,
                   round_nvcc_s={r: {cache_probe.object_name(obj): secs
                                     for obj, (_, secs) in d.items()}
                                 for r, d in done.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedules", default=",".join(SCHEDULES),
                    help="comma-separated, run in this order (repeats allowed)")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(args.schedules.split(",")):
            runs.append(schedule(name, pathlib.Path(tmp) / str(i)))
            print(f"{name}: build {runs[-1]['build_s']:.1f} s, probe "
                  f"{runs[-1].get('probe_s')} s", file=sys.stderr, flush=True)
    res = {"cpu_count": os.cpu_count(), "nvcc": _build.nvcc_version().strip().splitlines()[-1],
           "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
    print(json.dumps({"build_timing": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
