"""Cubic-spline primitives for the DNDA pipeline.

Port of ``defensive_model_vae_tpu/dnda/spline.py``.  The reference DNDA's
spline is the Forsythe–Malcolm–Moler (FMM) cubic with third-difference end
conditions (reference ``dnda_functions.spline/seval/SPL``, ``:91-251``), not
scipy's not-a-knot or natural spline; its end conditions are load-bearing for
curvature values near segment ends.

The hot paths (the FMM fit, the chord-rotate + fit + curvature maximum, the
uniform-arc Frenet resample, and their batched forms) run in
``native/dnda_spline.cpp``, whose arithmetic is that of the numpy bodies here
(:func:`fmm_spline_coeffs_numpy`, ``frenet.cartesian_to_frenet_numpy``,
``paths._max_curvature_numpy``).  The library is built on first use by
``g++`` into ``defensive_model_vae_tpu_torch/build/`` (``_native.py``) and
bound with ctypes.  There is no fallback: a library that does not build or
load raises with the compiler's output.  An input the native code rejects
(a non-zero return code) goes through the numpy version, as in the JAX
package, which then computes it or raises the same error.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Optional, Tuple

import numpy as np

from .. import _native

_PKG_ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_ROOT.parent / "native" / "dnda_spline.cpp"
BUILD_DIR = _PKG_ROOT / "build"
CXX = "g++"
_WHAT = "the DNDA spline library"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Attach the C prototypes (JAX ``spline.py::_bind`` :36)."""
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int64)
    i32ptr = ctypes.POINTER(ctypes.c_int32)
    lib.dmv_fmm_spline.restype = ctypes.c_int
    lib.dmv_fmm_spline.argtypes = [ctypes.c_int64] + [dptr] * 5
    lib.dmv_spline_eval.restype = None
    lib.dmv_spline_eval.argtypes = (
        [ctypes.c_int64] + [dptr] * 5 + [ctypes.c_int64] + [dptr] * 3
    )
    lib.dmv_max_curvature.restype = ctypes.c_int
    lib.dmv_max_curvature.argtypes = [ctypes.c_int64, dptr, dptr, dptr]
    lib.dmv_frenet.restype = ctypes.c_int
    lib.dmv_frenet.argtypes = (
        [ctypes.c_int64, dptr, dptr, ctypes.c_int64] + [dptr] * 8
    )
    lib.dmv_frenet_two_pass.restype = ctypes.c_int
    lib.dmv_frenet_two_pass.argtypes = (
        [ctypes.c_int64, dptr, dptr, ctypes.c_int64, ctypes.c_double,
         ctypes.c_int64] + [dptr] * 8 + [iptr]
    )
    lib.dmv_max_curvature_batch.restype = ctypes.c_int
    lib.dmv_max_curvature_batch.argtypes = (
        [ctypes.c_int64, iptr, iptr, dptr, dptr, dptr, i32ptr]
    )
    lib.dmv_frenet_batch.restype = ctypes.c_int
    lib.dmv_frenet_batch.argtypes = (
        [ctypes.c_int64, iptr, iptr, dptr, dptr, ctypes.c_int64]
        + [dptr] * 8 + [i32ptr]
    )
    return lib


def build() -> pathlib.Path:
    """Build the spline library for the current source unless it is built
    already; → its path.  Raises with the compiler's output on failure."""
    return _native.build(SOURCE, "libdmvspline", BUILD_DIR, CXX, _WHAT)


def _load_native() -> ctypes.CDLL:
    """The bound spline library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def max_curvature_native(x: np.ndarray, y: np.ndarray) -> Optional[float]:
    """Native chord-rotate + fit + curvature maximum (``paths._max_curvature``);
    None where the native code rejects the input."""
    lib = _load_native()
    x = np.ascontiguousarray(x, float)
    y = np.ascontiguousarray(y, float)
    out = ctypes.c_double()
    rc = lib.dmv_max_curvature(len(x), _dptr(x), _dptr(y), ctypes.byref(out))
    return out.value if rc == 0 else None


def frenet_native(pts: np.ndarray, m_equal: int):
    """Native uniform-arc resample (``frenet.cartesian_to_frenet``): the same
    tuple, or None where the native code rejects the input."""
    lib = _load_native()
    pts = np.ascontiguousarray(pts, float)
    px = np.ascontiguousarray(pts[:, 0])
    py = np.ascontiguousarray(pts[:, 1])
    m1 = m_equal + 1
    tx, ty = np.empty(m1), np.empty(m1)
    bx, cx, by, cy = np.empty(m1), np.empty(m1), np.empty(m1), np.empty(m1)
    ua, al = ctypes.c_double(), ctypes.c_double()
    rc = lib.dmv_frenet(
        pts.shape[0], _dptr(px), _dptr(py), m_equal,
        _dptr(tx), _dptr(ty), _dptr(bx), _dptr(cx), _dptr(by), _dptr(cy),
        ctypes.byref(ua), ctypes.byref(al),
    )
    if rc != 0:
        return None
    trans = np.column_stack([tx, ty])
    s_grid = np.arange(m_equal + 1) * ua.value
    return ua.value, al.value, trans, bx, cx, by, cy, s_grid


def _concat_batch(xs_list, ys_list):
    ns = np.array([len(x) for x in xs_list], np.int64)
    off = np.zeros(len(ns), np.int64)
    np.cumsum(ns[:-1], out=off[1:])
    xs = np.ascontiguousarray(np.concatenate(xs_list), float)
    ys = np.ascontiguousarray(np.concatenate(ys_list), float)
    return ns, off, xs, ys


def max_curvature_batch_native(xs_list, ys_list):
    """K paths' :func:`max_curvature_native` in one ctypes crossing; a list
    of floats, ``None`` where the native code rejected a path (the caller
    sends those through the scalar path)."""
    if not xs_list:
        return []
    lib = _load_native()
    ns, off, xs, ys = _concat_batch(xs_list, ys_list)
    k_out = np.empty(len(ns))
    rc = np.zeros(len(ns), np.int32)
    lib.dmv_max_curvature_batch(
        len(ns), _iptr(ns), _iptr(off), _dptr(xs), _dptr(ys), _dptr(k_out), _i32ptr(rc),
    )
    return [float(k) if r == 0 else None for k, r in zip(k_out, rc)]


def frenet_batch_native(xs_list, ys_list, m_equal: int):
    """K paths' :func:`frenet_native` at a shared ``m_equal`` in one ctypes
    crossing → ``(ua (K,), al (K,), tx, ty, bx, cx, by, cy — each (K,
    m_equal+1), rc (K,) int32)``; rows with ``rc != 0`` are uninitialised and
    must be filled through the scalar path."""
    m1 = m_equal + 1
    if not xs_list:
        z = np.empty(0)
        return (z, z, *([np.empty((0, m1))] * 6), np.zeros(0, np.int32))
    lib = _load_native()
    ns, off, xs, ys = _concat_batch(xs_list, ys_list)
    k = len(ns)
    tx, ty = np.empty((k, m1)), np.empty((k, m1))
    bx, cx = np.empty((k, m1)), np.empty((k, m1))
    by, cy = np.empty((k, m1)), np.empty((k, m1))
    ua, al = np.empty(k), np.empty(k)
    rc = np.zeros(k, np.int32)
    lib.dmv_frenet_batch(
        k, _iptr(ns), _iptr(off), _dptr(xs), _dptr(ys), m_equal,
        _dptr(tx), _dptr(ty), _dptr(bx), _dptr(cx), _dptr(by), _dptr(cy),
        _dptr(ua), _dptr(al), _i32ptr(rc),
    )
    return ua, al, tx, ty, bx, cx, by, cy, rc


def frenet_two_pass_native(pts: np.ndarray, m_coarse: int, unit_len: float):
    """Coarse-measure → fine-resample Frenet pass in one ctypes crossing (the
    per-frame hot path of ``core.prepare_frame``) → ``(unit_arc, arc_len,
    trans, bx, cx, by, cy, s_grid, m_equal)``, or None where the native code
    rejects the input (the caller then makes the two scalar calls; there
    ``m_equal`` is ``round(arc_len / unit_len)``, which the native code
    matches by ties-to-even ``nearbyint``)."""
    lib = _load_native()
    pts = np.ascontiguousarray(pts, float)
    px = np.ascontiguousarray(pts[:, 0])
    py = np.ascontiguousarray(pts[:, 1])
    cap = max(4 * pts.shape[0], 512)
    tx, ty = np.empty(cap + 1), np.empty(cap + 1)
    bx, cx = np.empty(cap + 1), np.empty(cap + 1)
    by, cy = np.empty(cap + 1), np.empty(cap + 1)
    ua, al = ctypes.c_double(), ctypes.c_double()
    m_eq = ctypes.c_int64()
    rc = lib.dmv_frenet_two_pass(
        pts.shape[0], _dptr(px), _dptr(py), m_coarse, unit_len, cap,
        _dptr(tx), _dptr(ty), _dptr(bx), _dptr(cx), _dptr(by), _dptr(cy),
        ctypes.byref(ua), ctypes.byref(al), ctypes.byref(m_eq),
    )
    if rc != 0:
        return None
    m1 = m_eq.value + 1
    trans = np.column_stack([tx[:m1], ty[:m1]])
    s_grid = np.arange(m1) * ua.value
    return (ua.value, al.value, trans, bx[:m1], cx[:m1], by[:m1], cy[:m1],
            s_grid, m_eq.value)


def _check_knots(x: np.ndarray) -> None:
    if len(x) < 2:
        raise ValueError("need at least 2 points")
    if not np.all(np.diff(x) > 0):
        raise ValueError("x must be strictly increasing")


def fmm_spline_coeffs(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FMM cubic-spline coefficients (b, c, d) at the knots, by the native code.

    s(t) = y_i + b_i·w + c_i·w² + d_i·w³ for w = t − x_i on [x_i, x_{i+1}].
    Requires strictly increasing x.  n = 2 degenerates to a line.
    """
    x = np.ascontiguousarray(x, float)
    y = np.ascontiguousarray(y, float)
    _check_knots(x)
    n = len(x)
    lib = _load_native()
    b, c, d = np.empty(n), np.empty(n), np.empty(n)
    rc = lib.dmv_fmm_spline(n, _dptr(x), _dptr(y), _dptr(b), _dptr(c), _dptr(d))
    if rc != 0:
        raise ValueError(f"native spline failed with code {rc}")
    return b, c, d


def fmm_spline_coeffs_numpy(x: np.ndarray, y: np.ndarray):
    """The numpy Thomas sweep of the same spline: the plain version the native
    ``dmv_fmm_spline`` is held to (JAX ``spline.py:258-304``)."""
    x = np.ascontiguousarray(x, float)
    y = np.ascontiguousarray(y, float)
    _check_knots(x)
    n = len(x)
    b = np.zeros(n)
    c = np.zeros(n)
    d = np.zeros(n)
    if n == 2:
        b[:] = (y[1] - y[0]) / (x[1] - x[0])
        return b, c, d

    h = np.diff(x)
    diag = np.zeros(n)
    rhs = np.zeros(n)
    diag[1:-1] = 2.0 * (h[:-1] + h[1:])
    slope = np.diff(y) / h
    rhs[1:-1] = np.diff(slope)

    # FMM end conditions (third differences)
    diag[0] = -h[0]
    diag[-1] = -h[-1]
    if n == 3:
        rhs[0] = 0.0
        rhs[-1] = 0.0
    else:
        c3 = np.diff(slope)
        rhs[0] = (c3[1] / (x[3] - x[1]) - c3[0] / (x[2] - x[0])) * h[0] ** 2 / (
            x[3] - x[0]
        )
        rhs[-1] = -(
            c3[-1] / (x[-1] - x[-3]) - c3[-2] / (x[-2] - x[-4])
        ) * h[-1] ** 2 / (x[-1] - x[-4])

    # Thomas forward elimination (sub/super diagonals are h)
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = diag[0]
    dp[0] = rhs[0]
    for i in range(1, n):
        m = h[i - 1] / cp[i - 1]
        cp[i] = diag[i] - m * h[i - 1]
        dp[i] = rhs[i] - m * dp[i - 1]
    sigma = np.zeros(n)
    sigma[-1] = dp[-1] / cp[-1]
    for i in range(n - 2, -1, -1):
        sigma[i] = (dp[i] - h[i] * sigma[i + 1]) / cp[i]

    c = sigma
    b[:-1] = slope - h * (c[1:] + 2.0 * c[:-1])
    d[:-1] = (c[1:] - c[:-1]) / h
    b[-1] = slope[-1] + h[-1] * (c[-2] + 2.0 * c[-1])
    c = 3.0 * c
    d[-1] = d[-2]
    return b, c, d


def spline_eval(
    x: np.ndarray,
    y: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    d: np.ndarray,
    u: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """The spline and its |curvature| at points u (the vectorised form of the
    reference's ``seval`` loop)."""
    u = np.asarray(u, float)
    idx = np.clip(np.searchsorted(x, u, side="right") - 1, 0, len(x) - 2)
    w = u - x[idx]
    d1 = 3 * d[idx] * w**2 + 2 * c[idx] * w + b[idx]
    d2 = 6 * d[idx] * w + 2 * c[idx]
    curvature = np.abs(d2) / (1 + d1**2) ** 1.5
    val = y[idx] + w * (b[idx] + w * (c[idx] + w * d[idx]))
    return val, curvature


def spline_curvature(x: np.ndarray, y: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Fit, then the curvature at u."""
    b, c, d = fmm_spline_coeffs(x, y)
    _, k = spline_eval(x, y, b, c, d, u)
    return k
