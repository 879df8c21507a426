"""The LU kernel's forms timed on the card, and where the register form's
time goes:

    python -m defensive_model_vae_tpu_torch.scripts.lu_profile [--out f.json]

For each case (the tracker's LM systems at the serve configuration, 16 and
134 rows; the horizon sweep's other orders at 16 rows; the order-40 tie
case), one JSON line:

- ``ms``: each of the register form, the shared-memory form and
  ``torch.linalg.solve_ex`` on the device alone (``ROUNDS`` rounds in
  turns, each ``CALLS`` calls queued behind a spin kernel, CUDA events, ms
  a call; the median and the range);
- ``cycles``: block 0's clock cycles a call in the register form's three
  phases (H in, the pivot steps, the back substitution), from the kernel
  built with ``-DLU_PHASES`` (``csrc/lu_solve.cu``) into a library of its
  own; ``sm_mhz``: the card's SM clock then (``nvidia-smi``), which turns
  cycles into time.

The register form and the timed library are the production build
(``ops/_build.py``); the phase build only counts cycles.  Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile

import torch

from ..control import mpc
from ..control import tracker_inputs as tp
from ..control.sweep import COMBOS
from ..ops import _build
from ..ops import lu_solve as lus
from . import lu_checks as luc

ROUNDS, CALLS, SPIN_CYCLES = 5, 50, 50_000_000


def cases(dev):
    """[(name, H, g)]: the serve order at 16 and 134 rows, the sweep's other
    orders at 16, the order-40 tie case."""
    out = [(f"tracker_{B}x40", *luc.lm_systems(B, dev)) for B in (16, 134)]
    for P, M in COMBOS:
        if M != tp.CFG.control_horizon:
            cfg = mpc.MPCConfig(prediction_horizon=P, control_horizon=M, dt=tp.CFG.dt)
            out.append((f"sweep_16x{2 * M}", *luc.lm_systems(16, dev, cfg)))
    H, g = luc.tie_case(40)
    out.append(("tie_16x40", torch.from_numpy(H).to(dev), torch.from_numpy(g).to(dev)))
    return out


def phase_library(workdir: str) -> ctypes.CDLL:
    """``csrc/lu_solve.cu`` built with ``-DLU_PHASES`` in ``workdir``."""
    so = f"{workdir}/liblu_phases.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DLU_PHASES", "-shared", "-o", so,
           str(_build.CSRC / "lu_solve.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.lu_solve_batched.restype = ctypes.c_int
    lib.lu_solve_batched.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.lu_solve_phases.restype = ctypes.c_int
    lib.lu_solve_phases.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def device_ms(fn) -> float:
    """ms of one of CALLS calls of ``fn`` on the device alone."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(CALLS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / CALLS


def profile_case(lib, H, g) -> dict:
    fns = {"reg": lambda: lus.lu_solve(H, g, form="reg"),
           "smem": lambda: lus.lu_solve(H, g, form="smem"),
           "solve_ex": lambda: lus._lu_solve_plain(H, g)}
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(ROUNDS):
        for k in order:
            times[k].append(device_ms(fns[k]))
    x = torch.empty_like(g)
    out = (ctypes.c_longlong * 4)()
    lib.lu_solve_phases(out)  # zero
    stream = torch.cuda.current_stream(H.device).cuda_stream
    for _ in range(CALLS):
        err = lib.lu_solve_batched(H.data_ptr(), g.data_ptr(), x.data_ptr(), H.shape[0],
                                   H.shape[1], lus.FORMS.index("reg"), stream)
        if err:
            raise RuntimeError(f"the phase build's launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    if lib.lu_solve_phases(out):
        raise RuntimeError("reading the phase build's cycles failed")
    calls = max(out[3], 1)
    return {"rows": H.shape[0], "order": H.shape[1], "instance": lus.instance(H.shape[1]),
            "ms": {k: {"median": sorted(v)[len(v) // 2], "range": [min(v), max(v)]}
                   for k, v in times.items()},
            "cycles": {"h_in": out[0] / calls, "pivot_steps": out[1] / calls,
                       "back_substitution": out[2] / calls},
            "phase_equal": bool(torch.equal(x, lus.lu_solve(H, g, form="reg")))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines' objects to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lu_profile needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = ["nvidia-smi", "--format=csv,noheader"]
    card = subprocess.run(smi + ["--query-gpu=name,power.limit"], capture_output=True,
                          text=True, timeout=30).stdout.strip()
    result = {"card": card, "cases": {}}
    with tempfile.TemporaryDirectory() as d:
        lib = phase_library(d)
        for name, H, g in cases(dev):
            row = profile_case(lib, H, g)
            row["sm_mhz"] = subprocess.run(smi + ["--query-gpu=clocks.sm"], capture_output=True,
                                           text=True, timeout=30).stdout.strip()
            result["cases"][name] = row
            print(json.dumps({"case": name, **row}), flush=True)
    print(json.dumps({"card": card}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
