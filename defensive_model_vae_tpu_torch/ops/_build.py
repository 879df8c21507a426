"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface (no PyTorch headers),
so ``nvcc`` builds it into a shared library in seconds.  The library lands
in ``defensive_model_vae_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so a changed source is rebuilt
and an unchanged one is loaded as it is.  Nothing is built at import time:
:func:`load` builds at a kernel's first launch, and :func:`build_all`
builds every kernel at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

PKG_ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name → (source, {C function: (restype, argtypes)})
_P = ctypes.c_void_p
KERNELS: Dict[str, tuple] = {
    "fused_trainer": ("fused_trainer.cu", {
        "k1_fused_train": (ctypes.c_int, [
            _P, _P, _P, _P, _P, _P,            # x, cond, eps, params, work, metrics
            ctypes.c_int, ctypes.c_int,        # B, epochs
            ctypes.c_float,                    # lr
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            ctypes.c_ulonglong, _P,            # seed, stream
        ]),
        "k2_fused_train_multi": (ctypes.c_int, [
            _P, _P, _P,                        # x, cond, eps (sum B_s rows)
            _P, _P, ctypes.c_int,              # row offsets, seeds, S
            _P, _P, _P,                        # params, work, metrics
            ctypes.c_int, ctypes.c_float,      # epochs, lr
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            _P,                                # stream
        ]),
        "k1_fused_train_seeds": (ctypes.c_int, [
            _P, _P, _P,                        # x, cond (B rows), eps (S B rows)
            _P, ctypes.c_int,                  # seeds, S
            _P, _P, _P,                        # params, work, metrics
            ctypes.c_int, ctypes.c_int,        # B, epochs
            ctypes.c_float,                    # lr
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            _P,                                # stream
        ]),
        "k1_param_floats": (ctypes.c_longlong, []),
        "k1_work_floats": (ctypes.c_longlong, [ctypes.c_int]),
    }),
    "fused_scale": ("fused_scale.cu", {
        "k3_train": (ctypes.c_int, [
            _P, ctypes.c_int, _P,              # packed corpus, its width, eps stream
            ctypes.c_int, ctypes.c_int,        # bf16, noise mode
            ctypes.c_longlong, ctypes.c_int,   # n_pad, tile
            ctypes.c_float, ctypes.c_int,      # n_valid, epochs
            ctypes.c_float,                    # lr
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            ctypes.c_ulonglong,                # seed
            _P, _P, _P, ctypes.c_int,          # params, m|v, partials, SM count
            _P, _P,                            # metrics, stream
        ]),
        "k4_grad_epoch": (ctypes.c_int, [
            _P, ctypes.c_int, _P,              # packed corpus, its width, eps stream
            ctypes.c_int, ctypes.c_int,        # bf16, noise mode
            ctypes.c_longlong, ctypes.c_int,   # n_pad, tile
            ctypes.c_float,                    # n_valid
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            ctypes.c_ulonglong,                # prng stream base
            _P, _P, ctypes.c_int,              # params, partials, SM count
            _P, _P, _P,                        # grad, loss row, stream
        ]),
        "ks_param_floats": (ctypes.c_longlong, []),
        "ks_partial_floats": (ctypes.c_longlong, []),
        "ks_chunks": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int]),
    }),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> pathlib.Path:
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; → (Popen, tmp path, final path) or
    None when the library for this source is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, started, timeout: float) -> str:
    proc, tmp, out = started
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc for {name} did not finish in {timeout} s")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    return log


def build_all(timeout: float = 300.0) -> Dict[str, dict]:
    """Build every kernel, one ``nvcc`` per source started together.
    → {name: {"seconds": wall time, "log": nvcc's output (ptxas -v)}}."""
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in KERNELS}
    out = {}
    for n, s in started.items():
        log = "" if s is None else _finish_build(n, s, timeout)
        out[n] = {"seconds": time.perf_counter() - t0, "log": log,
                  "cached": s is None}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    started = _start_build(name)
    if started is not None:
        _finish_build(name, started, 300.0)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (restype, argtypes) in KERNELS[name][1].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _LOADED[name] = lib
    return lib
