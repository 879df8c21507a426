"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds.  A kernel library is one or more objects:
each (source, defines) pair of its entry compiles to an object, every
object of every library in its own ``nvcc`` started together, and the
objects are linked into one shared library.  It lands in
``defensive_model_vae_tpu_torch/build/`` (listed in ``.gitignore``), named
by a SHA-256 of its sources, the headers under ``csrc/``, the flags and
``nvcc --version``'s output, so a changed source or another compiler is
rebuilt and an unchanged one is loaded as it is.  The key is a digest of
file contents, so it is the same in every process (no hash seed enters it).
Nothing is built at import time: :func:`load` builds at a kernel's first
launch, and :func:`build_all` builds every kernel at once.  One object is
a CPython module rather than plain C: P3's launch
(``csrc/cache_decoy_py.cpp``, :func:`load_module`), where the host work of
a ctypes call is a share of the kernel's time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
import threading
import time
from typing import Dict

if __package__:
    from ..utils.profiling import span
else:  # loaded as a module of its own (scripts/p1_stream_ab.py, mint_provenance_probe.py)
    from contextlib import nullcontext as span

PKG_ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"

# Python's headers, for the one object that is a CPython module
PY_INCLUDE = sysconfig.get_paths()["include"]
PY_HEADERS = "-I" + PY_INCLUDE

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name → ((source, extra nvcc flags) per object,
#                {C function: (restype, argtypes)})
_P = ctypes.c_void_p
_K1_ARGS = [
    _P, _P, _P, _P, _P, _P,            # x, cond, eps, params, work, metrics
    ctypes.c_int, ctypes.c_int,        # B, epochs
    ctypes.c_float,                    # lr
    ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
    ctypes.c_float, ctypes.c_float,    # start, time
    ctypes.c_ulonglong,                # seed
    ctypes.c_int, _P, _P, _P,          # cluster size (0: pick), timer, size taken, stream
]
_K2_ARGS = [
    _P, _P, _P,                        # x, cond, eps (sum B_s rows)
    _P, _P, ctypes.c_int,              # row offsets, seeds, S
    _P, _P, _P,                        # params, work, metrics
    ctypes.c_int, ctypes.c_float,      # epochs, lr
    ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
    ctypes.c_float, ctypes.c_float,    # start, time
    ctypes.c_int,                      # metrics store: 0 full, 1 static (row 0)
    ctypes.c_int, _P, _P, _P,          # cluster size (0: pick), timer, size taken, stream
]
_SEEDS_ARGS = [
    _P, _P, _P,                        # x, cond (B rows), eps (S B rows)
    _P, ctypes.c_int,                  # seeds, S
    _P, _P, _P,                        # params, work, metrics
    ctypes.c_int, ctypes.c_int,        # B, epochs
    ctypes.c_float,                    # lr
    ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
    ctypes.c_float, ctypes.c_float,    # start, time
    ctypes.c_int, _P, _P, _P,          # cluster size (0: pick), timer, size taken, stream
]
_K3_HEAD = [
    _P, ctypes.c_int, _P,              # packed corpus, its width, eps stream
    ctypes.c_int, ctypes.c_int,        # bf16 (auto: the dtype mode), noise mode
    ctypes.c_longlong, ctypes.c_int,   # n_pad, tile
]
_K4_ARGS = _K3_HEAD + [
    ctypes.c_float,                    # n_valid
    ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
    ctypes.c_float, ctypes.c_float,    # start, time
    ctypes.c_ulonglong,                # prng stream base
    _P, _P, ctypes.c_int,              # params, partials, SM count
    _P, _P,                            # grad, loss row
    _P, _P,                            # bf16 copy of the params, scratch
    _P,                                # stream
]
_K3_BODY = [
    ctypes.c_float, ctypes.c_int,      # n_valid, epochs
    ctypes.c_float,                    # lr
    ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
    ctypes.c_float, ctypes.c_float,    # start, time
    ctypes.c_ulonglong,                # seed
    _P, _P, _P, ctypes.c_int,          # params, m|v, partials, SM count
    _P,                                # metrics
]


class MpcConsts(ctypes.Structure):
    """``csrc/mpc_step.cu``'s ``MpcConsts``, passed by value."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "inv_l", "max_accel", "max_steer", "w_th", "w_v", "wf_th", "wf_v",
        "sr_a", "sr_d", "lam0")] + [("P", ctypes.c_int), ("M", ctypes.c_int)]


KERNELS: Dict[str, tuple] = {
    # K1's manual instances, then its autodiff instance (entries *_auto)
    "fused_trainer": ((("fused_trainer.cu", ()), ("fused_trainer.cu", ("-DK1_AUTO",))), {
        "k1_fused_train": (ctypes.c_int, _K1_ARGS),
        "k2_fused_train_multi": (ctypes.c_int, _K2_ARGS),
        "k1_fused_train_seeds": (ctypes.c_int, _SEEDS_ARGS),
        "k1_fused_train_auto": (ctypes.c_int, _K1_ARGS),
        "k2_fused_train_multi_auto": (ctypes.c_int, _K2_ARGS),
        "k1_fused_train_seeds_auto": (ctypes.c_int, _SEEDS_ARGS),
        "k1_param_floats": (ctypes.c_longlong, []),
        "k1_work_floats": (ctypes.c_longlong, [ctypes.c_int]),
    }),
    # K3's production instances, one object per ablation knob, then one per
    # dtype mode of the autodiff instance
    "fused_scale": ((("fused_scale.cu", ()),) + tuple(
        ("fused_scale_knob.cu", (f"-DKS_KNOB={bit}",)) for bit in (2, 4, 8, 16, 32, 64))
        + tuple(("fused_scale_auto.cu", (f"-DKS_AUTO_MODE={m}",)) for m in (0, 1, 2)), {
        "k3_train": (ctypes.c_int, _K3_HEAD + _K3_BODY + [
            _P, _P,                            # bf16 copy of the params, scratch
            ctypes.c_int, _P,                  # ablation bits, noadam sink
            _P,                                # stream
        ]),
        "k4_grad_epoch": (ctypes.c_int, _K4_ARGS),
        "k3_train_auto": (ctypes.c_int, _K3_HEAD + _K3_BODY + [
            _P, _P,                            # bf16 copy of the params, scratch
            _P,                                # stream
        ]),
        "k4_grad_epoch_auto": (ctypes.c_int, _K4_ARGS),
        "ks_engine": (ctypes.c_int, []),
        "ks_weights_bf16": (ctypes.c_int, [_P, _P, _P]),  # params, bf16 copy, stream
        "ks_scratch_elems": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int]),
        "ks_scratch_elems_auto": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int]),
        "ks_param_floats": (ctypes.c_longlong, []),
        "ks_partial_floats": (ctypes.c_longlong, []),
        "ks_chunks": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int]),
        "ks_chunks_auto": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int]),
    }),
    "scale_ablation": ((("scale_ablation.cu", ()),), {
        "p1_stream": (ctypes.c_int, [
            _P, ctypes.c_longlong, ctypes.c_int,  # packed corpus, its elements, epochs
            _P, _P, ctypes.c_int,              # partials, tickets, grid
            _P, _P,                            # metrics, stream
        ]),
        "p1_stream_grid": (ctypes.c_int, [ctypes.c_int]),
        "p1_ablation": (ctypes.c_int, [
            _P, ctypes.c_int, ctypes.c_longlong,  # packed corpus, width, rows
            ctypes.c_float, ctypes.c_int,      # n_valid, mode (0 fwd, 1 dx)
            ctypes.c_float, ctypes.c_float,    # loss weights: recon, kld
            ctypes.c_float, ctypes.c_float,    # start, time
            _P, ctypes.c_int, _P, ctypes.c_int,  # params, epochs, partials, SMs
            _P, _P,                            # metrics, stream
        ]),
        "p2_stream_sum": (ctypes.c_int, [
            _P, ctypes.c_longlong,             # eps, elements
            _P, _P, ctypes.c_int,              # partials, ticket, grid
            _P, _P,                            # (1, 8) out, stream
        ]),
        "p2_grid": (ctypes.c_int, [ctypes.c_int]),
        "sa_param_floats": (ctypes.c_longlong, []),
        "sa_cuda_launches": (ctypes.c_longlong, [ctypes.c_int]),
        "sa_chunks": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int]),
    }),
    # P1-sol on wgmma: a source of its own, so scale_ablation.cu's object
    # (and its nvcc time) stays as it was
    "p1_sol": ((("p1_sol.cu", ()),), {
        "p1_sol": (ctypes.c_int, [
            _P, ctypes.c_int, ctypes.c_longlong,  # packed corpus, width, rows
            _P, _P, ctypes.c_int,              # w_in, w_chain (bf16), chain length
            ctypes.c_int, _P, ctypes.c_int,    # epochs, partials, grid
            _P, _P,                            # metrics, stream
        ]),
        "p1_sol_grid": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),  # SM count, width
        "p1_sol_partials": (ctypes.c_longlong, [ctypes.c_int]),       # grid
        "p1_sol_cuda_launches": (ctypes.c_longlong, []),
    }),
    # the MPC tracker's batched solve (no Pallas counterpart: JAX's
    # jnp.linalg.solve, which the captured tracker step cannot take from
    # MAGMA), its two forms (shared memory, registers) in one object
    "lu_solve": ((("lu_solve.cu", ()),), {
        "lu_solve_batched": (ctypes.c_int, [
            _P, _P, _P,                        # H (B, n, n), g, x (B, n)
            ctypes.c_int, ctypes.c_int,        # B, n
            ctypes.c_int, _P,                  # form (0 smem, 1 reg), stream
        ]),
        "lu_solve_reg_bound": (ctypes.c_int, [ctypes.c_int]),  # n → instance, 0: none
        "lu_solve_launches": (ctypes.c_int, [ctypes.POINTER(ctypes.c_ulonglong)]),  # [2]
        "lu_solve_reset_launches": (ctypes.c_int, []),
    }),
    # the MPC tracker's step around the LU kernel (no Pallas counterpart:
    # JAX's tracker is plain XLA); -fmad=false, so that its products and sums
    # round as its plain mirror's torch ops do (csrc/mpc_step.cu)
    "mpc_step": ((("mpc_step.cu", ("-fmad=false",)),), {
        "mpc_form": (ctypes.c_int, [
            _P, _P, _P, _P, _P, _P,            # u, state, ref, last, first, lam
            _P, _P, _P,                        # H, g, cost0
            ctypes.c_int, MpcConsts,           # B, the configuration's constants
            ctypes.c_int, ctypes.c_int, _P,    # iteration, freeze, stream
        ]),
        "mpc_update": (ctypes.c_int, [
            _P, _P, _P, _P, _P, _P, _P, _P,    # x, u, state, ref, last, first, lam, cost0
            ctypes.c_int, MpcConsts,           # B, the configuration's constants
            ctypes.c_int, ctypes.c_int, _P,    # iteration, apply, stream
        ]),
        "mpc_step_bounds": (ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),  # [2]: P, M
        "mpc_step_launches": (ctypes.c_int, [ctypes.POINTER(ctypes.c_ulonglong)]),  # [2]
        "mpc_step_reset_launches": (ctypes.c_int, []),
    }),
    # P3, and its launch as a CPython function (load_module): that object
    # alone takes Python's headers, whose directory its flags name
    "cache_decoy": ((("cache_decoy.cu", ()),
                     ("cache_decoy_py.cpp", (PY_HEADERS,))), {
        "p3_decoy": (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P]),  # x, out, n, stream
    }),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version``'s output: part of every library's key."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    for src, defines in KERNELS[name][0]:
        h.update(src.encode() + " ".join(defines).encode() + (CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


class _Nvcc:
    """One object's ``nvcc``, started at once; a thread reads its output and
    notes the seconds from the start to its exit."""

    def __init__(self, cmd, obj: pathlib.Path):
        self.obj, self.log, self.seconds = obj, "", None
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        self.log, _ = self.proc.communicate()
        self.seconds = time.perf_counter() - self._t0

    def wait(self, timeout: float) -> bool:
        """Whether it ended within ``timeout`` seconds."""
        self._reader.join(timeout)
        return not self._reader.is_alive()

    def kill(self):
        self.proc.kill()
        self._reader.join()


def _start_build(name: str):
    """Start one ``nvcc`` per object of kernel ``name``; → (the objects'
    :class:`_Nvcc`, final path) or None when the library for these sources
    is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    for src, defines in KERNELS[name][0]:
        if PY_HEADERS in defines and not os.path.exists(os.path.join(PY_INCLUDE, "Python.h")):
            raise RuntimeError(f"{src} of {name} includes Python.h, which is not in "
                               f"{PY_INCLUDE}: install Python's development headers")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (src, defines) in enumerate(KERNELS[name][0]):
        obj = out.with_suffix(f".{i}.{os.getpid()}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(CSRC / src)]
        procs.append(_Nvcc(cmd, obj))
    return procs, out


def _finish_build(name: str, started, timeout: float):
    """Wait for the objects, link them into the library → (nvcc's output,
    each object's nvcc seconds)."""
    procs, out = started
    deadline = time.monotonic() + timeout
    for p in procs:
        if not p.wait(max(1.0, deadline - time.monotonic())):
            for q in procs:
                q.kill()
            raise RuntimeError(f"nvcc for {name} did not finish in {timeout} s")
    failed = next((p.log for p in procs if p.proc.returncode != 0), None)
    objs = [p.obj for p in procs]
    try:
        if failed is not None:
            raise RuntimeError(f"nvcc failed for {name}:\n{failed}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True,
                              timeout=max(1.0, deadline - time.monotonic()))
        if link.returncode != 0:
            raise RuntimeError(f"nvcc could not link {name}:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(p.log for p in procs), [p.seconds for p in procs]


def object_names(name: str):
    """Kernel ``name``'s objects as ``source [defines]`` strings."""
    return [" ".join((src,) + tuple(defines)) for src, defines in KERNELS[name][0]]


def build_all(timeout: float = 300.0) -> Dict[str, dict]:
    """Build every kernel, one ``nvcc`` per object, all started together.
    → {name: {"seconds": wall time to its link, "log": nvcc's output
    (ptxas -v), "nvcc_s": {object: its nvcc's seconds}, "cached"}}."""
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in KERNELS}
    out = {}
    for n, s in started.items():
        log, secs = ("", []) if s is None else _finish_build(n, s, timeout)
        out[n] = {"seconds": time.perf_counter() - t0, "log": log,
                  "nvcc_s": dict(zip(object_names(n), secs)), "cached": s is None}
    return out


def load_module(name: str, module: str):
    """The CPython module ``module`` that kernel ``name``'s library also
    holds, built first if needed."""
    load(name)
    spec = importlib.util.spec_from_file_location(module, _lib_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tensor_core_ops(lib_path) -> Dict[str, int]:
    """The HMMA and HGMMA instructions in a built library's SASS
    (``cuobjdump -sass``), counted over all its objects."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout.splitlines()
    return {op: sum(f" {op}." in ln or f" {op} " in ln for ln in sass)
            for op in ("HMMA", "HGMMA")}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    with span(f"build.{name}"):
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
