"""Is an nvcc build of the port's kernels a pure function of its inputs?

Port of the JAX package's ``scripts/cache_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.cache_probe [--out FILE]

JAX's probe asks whether the Mosaic lowering of its production kernels is
deterministic (the same text twice in one process) and independent of the
trace context (the same after an unrelated Pallas kernel was traced), since
either fault mints fresh entries in its compilation cache.  The port's
counterpart of a lowering is the ``nvcc`` build of the object that holds
the kernel, with ``ops/_build.py``'s flags and defines; its cache is the
``build/`` directory, keyed by a SHA-256 of the sources, headers, flags and
``nvcc --version`` (``_build._lib_path``).  That key is a digest of file
contents, the same in every process, so no hash seed needs pinning (JAX's
probe and CLI pin ``PYTHONHASHSEED``; this script does not).

JAX's specs and the objects that serve them here:

  fused_whole        fused_trainer.cu: K1's manual instances (JAX's
                     ``_fused_call`` with its default backward)
  scale_hbm_manual   fused_scale.cu: K3's production instances
  scale_prng_manual  the same object: the noise mode is a runtime argument
  scale_prng_auto    fused_scale_auto.cu -DKS_AUTO_MODE=1: K3's f32_acts
                     autodiff instance

Three rounds, each in a fresh temporary directory with every object's
``nvcc -cubin`` started together: A and A2 in the canonical order; B,
after the decoy (P3, ``ops/cache_decoy.py``, the port of JAX's ``_decoy``)
was compiled in B's directory, built and launched, and held against its
plain version bit for bit, in the reversed order.  Each ``nvcc`` is a
process of its own, whose context is its directory, its flags and what
was built before it, not this process's state; so the rounds run side by
side (A and A2 first, B once the decoy has run), and ``chip_smoke.py``
runs them beside its build of every kernel.  Each cubin is hashed (SHA-256, 12 hex digits); where two
rounds' bytes differ, the hashes of their ``cuobjdump -sass`` decide.
Verdicts as JAX's: ``deterministic`` / ``NONDETERMINISTIC-IN-CONTEXT``
(A against A2) and ``context-stable`` / ``CONTEXT-DEPENDENT`` (A against
B).  It prints a line per spec, the library key each object's library
takes, nvcc's version, and one JSON line.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from .._device import resolve_device
from ..ops import _build
from ..ops import cache_decoy

# JAX's spec → (library, object index in _build.KERNELS[library][0])
SPECS = (
    ("fused_whole", "fused_trainer", 0),
    ("scale_hbm_manual", "fused_scale", 0),
    ("scale_prng_manual", "fused_scale", 0),
    ("scale_prng_auto", "fused_scale",
     _build.KERNELS["fused_scale"][0].index(("fused_scale_auto.cu", ("-DKS_AUTO_MODE=1",)))),
)


def objects(specs=SPECS):
    """The distinct (library, index) objects of ``specs``, in spec order."""
    out = []
    for _, lib, idx in specs:
        if (lib, idx) not in out:
            out.append((lib, idx))
    return out


def object_name(obj) -> str:
    src, defines = _build.KERNELS[obj[0]][0][obj[1]]
    return " ".join((src,) + tuple(defines))


def _cubin_cmd(obj, out: pathlib.Path):
    src, defines = _build.KERNELS[obj[0]][0][obj[1]]
    return [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-cubin", "-o", str(out),
            str(_build.CSRC / src)]


def start_round(objs, workdir: pathlib.Path):
    """Start every object's ``nvcc -cubin`` into ``workdir`` at once →
    [(object, cubin path, process)]."""
    workdir.mkdir(parents=True, exist_ok=True)
    started = []
    for i, obj in enumerate(objs):
        path = workdir / f"{i}.cubin"
        started.append((obj, path, subprocess.Popen(_cubin_cmd(obj, path),
                                                     stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    return started


def finish_round(started, timeout: float):
    """Wait for a round's nvccs → {object: cubin path}."""
    deadline = time.monotonic() + timeout
    out = {}
    for obj, path, proc in started:
        try:
            log, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for _, _, p in started:
                p.kill()
                p.communicate()
            raise RuntimeError(f"nvcc did not finish in {timeout} s")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {object_name(obj)}:\n{log}")
        out[obj] = path
    return out


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:12]


def _sass(path: pathlib.Path) -> bytes:
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          check=True, timeout=120).stdout


def verdicts(a: str, a2: str, b: str):
    """JAX's two verdicts from three digests of one object."""
    return ("deterministic" if a == a2 else "NONDETERMINISTIC-IN-CONTEXT",
            "context-stable" if a == b else "CONTEXT-DEPENDENT")


def compare(paths):
    """{obj: {round: cubin path}} → {obj: row}: the cubins' digests, and
    where their bytes differ the digests of their SASS, with the verdicts
    read off whichever level decided."""
    rows = {}
    for obj, by_round in paths.items():
        data = {r: p.read_bytes() for r, p in by_round.items()}
        row = {"object": object_name(obj), "bytes": len(data["A"]),
               **{r: _digest(d) for r, d in data.items()}}
        level = "cubin"
        if len({row[r] for r in data}) > 1:
            level = "sass"
            row.update({f"{r}_sass": _digest(_sass(p)) for r, p in by_round.items()})
        key = "" if level == "cubin" else "_sass"
        det, ctx = verdicts(row["A" + key], row["A2" + key], row["B" + key])
        row.update(compared=level, determinism=det, context=ctx)
        rows[obj] = row
    return rows


class Probe:
    """The three rounds, started one after another without waiting:
    :meth:`start` ("A", "A2", then "B" after :meth:`decoy`), then
    :meth:`finish` for the result.  :meth:`close` stops what still runs."""

    def __init__(self, timeout: float = 80.0):
        self.timeout = timeout
        self.objs = objects()
        self.root = pathlib.Path(tempfile.mkdtemp(prefix="cache_probe_"))
        self.started = {}
        self.p3 = None
        self.t0 = time.perf_counter()

    def _dir(self, rnd):
        d = self.root / rnd
        d.mkdir(exist_ok=True)
        return d

    def start(self, rnd: str):
        order = self.objs if rnd != "B" else list(reversed(self.objs))
        if rnd == "B" and self.p3 is None:
            raise RuntimeError("round B starts after the decoy")
        self.started[rnd] = (start_round(order, self._dir(rnd)), time.perf_counter())

    def decoy(self, dev):
        """P3: compiled in round B's directory, built and launched, held
        against x * 2 + 1 bit for bit → {exact, max_abs_err}; raises if it
        disagrees."""
        if dev.type != "cuda":
            raise RuntimeError("the cache probe launches P3 on the card")
        finish_round(start_round([("cache_decoy", 0)], self._dir("B") / "decoy"),
                     self.timeout)
        x = torch.randn(cache_decoy.SHAPE, generator=torch.Generator().manual_seed(0))
        got = cache_decoy.decoy(x.to(dev)).cpu()
        want = cache_decoy._decoy_plain(x)
        self.p3 = {"exact": bool(torch.equal(got, want)),
                   "max_abs_err": float((got - want).abs().max())}
        if not self.p3["exact"]:
            raise RuntimeError(f"P3 disagrees with x * 2 + 1: {self.p3}")
        return self.p3

    def finish(self):
        """Wait for every round → the result dict (and remove the cubins)."""
        try:
            paths = {obj: {} for obj in self.objs}
            rounds = {}
            for rnd, (started, t_start) in self.started.items():
                for obj, path in finish_round(started, self.timeout).items():
                    paths[obj][rnd] = path
                rounds[rnd] = time.perf_counter() - t_start
            rows = compare(paths)
        finally:
            self.close()
        libs = sorted({lib for lib, _ in self.objs})
        return {"specs": {name: rows[(lib, idx)] for name, lib, idx in SPECS},
                "library_keys": {lib: _build._lib_path(lib).name for lib in libs},
                "nvcc": _build.nvcc_version().strip().splitlines()[-1],
                "p3": self.p3, "round_s": rounds,
                "seconds": time.perf_counter() - self.t0,
                "all_stable": all(r["determinism"] == "deterministic"
                                  and r["context"] == "context-stable"
                                  for r in rows.values())}


    def close(self):
        """Stop every nvcc still running and remove the rounds' directory."""
        for started, _ in self.started.values():
            for _, _, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        shutil.rmtree(self.root, ignore_errors=True)


def run(dev, timeout: float = 80.0):
    """The three rounds → the result dict.  Raises if P3 disagrees with its
    plain version."""
    if dev.type != "cuda":
        raise RuntimeError("the cache probe builds with nvcc and launches P3 on the card")
    probe = Probe(timeout)
    try:
        probe.start("A")
        probe.start("A2")
        probe.decoy(dev)
        probe.start("B")
        return probe.finish()
    finally:
        probe.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=80.0,
                    help="seconds for each round's nvccs")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), args.timeout)
    for name, row in out["specs"].items():
        print(f"{name}: {row['object']}  bytes={row['bytes']}  A={row['A']} "
              f"A2={row['A2']} B={row['B']}  [{row['determinism']}, {row['context']}]")
    for lib, key in out["library_keys"].items():
        print(f"library {lib}: {key}")
    print(f"nvcc: {out['nvcc']}")
    print("PROBE:", "all builds stable" if out["all_stable"] else "divergence found above")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"cache_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
