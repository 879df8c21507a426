"""CSV input through the native C++ loader, without pandas.

Port of ``defensive_model_vae_tpu/data/csv_io.py``.  ``read_csv`` parses a
CARLA log CSV with the mmap + ``std::from_chars`` loader in
``native/csvloader.cpp`` and returns a :class:`Frame`: the column names over
one float64 matrix, with the column access, masks and row slices the
scenario predicates and the extraction code use.

The loader is built on first use with ``g++ -O2 -std=c++17 -fPIC -shared``
into ``defensive_model_vae_tpu_torch/build/``, named by a SHA-256 of the
source, the flags and ``g++ --version`` (as ``ops/_build.py`` names its
libraries), and bound with ctypes.  There is no fallback: a loader that
does not build or load raises with the compiler's output, and a file the
loader cannot parse raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_PKG_ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_ROOT.parent / "native" / "csvloader.cpp"
BUILD_DIR = _PKG_ROOT / "build"
CXX, CXX_FLAGS = "g++", ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class FrameRow:
    """One row of a :class:`Frame`: ``row[name]`` and ``row.get(name,
    default)`` give Python floats."""

    __slots__ = ("_index", "_values")

    def __init__(self, index: Dict[str, int], values: np.ndarray):
        self._index = index
        self._values = values

    def __getitem__(self, name: str) -> float:
        return float(self._values[self._index[name]])

    def get(self, name: str, default=None):
        i = self._index.get(name)
        return default if i is None else float(self._values[i])


class Frame:
    """Column names over a (rows, cols) float64 matrix.

    ``frame[name]`` is a column (float64 array), ``frame[[a, b]]`` the
    (rows, 2) matrix of those columns, ``frame[mask]`` the rows where a
    boolean array is true; ``name in frame``, ``len(frame)``,
    :meth:`rows` (positional slices, end excluded) and :meth:`row`.
    Where several columns share a name, the first is the one read."""

    __slots__ = ("columns", "data", "_index")

    def __init__(self, columns: Sequence[str], data: np.ndarray):
        data = np.asarray(data, np.float64)
        if data.ndim != 2 or data.shape[1] != len(columns):
            raise ValueError(f"{len(columns)} column names for a matrix of shape "
                             f"{data.shape}")
        self.columns: List[str] = list(columns)
        self.data = data
        self._index: Dict[str, int] = {}
        for i, name in enumerate(self.columns):
            self._index.setdefault(name, i)

    def __len__(self) -> int:
        return self.data.shape[0]

    def __contains__(self, name) -> bool:
        return name in self._index

    def __getitem__(self, key: Union[str, Sequence[str], np.ndarray]):
        if isinstance(key, str):
            return self.data[:, self._index[key]]
        if isinstance(key, (list, tuple)):
            return self.data[:, [self._index[k] for k in key]]
        mask = np.asarray(key)
        if mask.dtype != bool or mask.shape != (len(self),):
            raise TypeError("a Frame is indexed by a column name, a list of names "
                            f"or a boolean mask of {len(self)} rows")
        return Frame(self.columns, self.data[mask])

    def rows(self, start: int, stop: Optional[int] = None) -> "Frame":
        """Rows ``start`` up to (not including) ``stop``, by position."""
        return Frame(self.columns, self.data[start:stop])

    def row(self, i: int) -> FrameRow:
        return FrameRow(self._index, self.data[i])


def library_path() -> pathlib.Path:
    """Where the loader for this source, these flags and this compiler lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    try:
        version = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"the CSV loader needs a C++ compiler ({CXX}): {e}") from e
    h.update(version.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdmvcsv_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Build the loader for the current source unless it is built already;
    → the library's path.  Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the CSV loader failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a half-written .so
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dmv_csv_open.restype = ctypes.c_void_p
        lib.dmv_csv_open.argtypes = [ctypes.c_char_p]
        lib.dmv_csv_rows.restype = ctypes.c_int64
        lib.dmv_csv_rows.argtypes = [ctypes.c_void_p]
        lib.dmv_csv_cols.restype = ctypes.c_int64
        lib.dmv_csv_cols.argtypes = [ctypes.c_void_p]
        lib.dmv_csv_header.restype = ctypes.c_char_p
        lib.dmv_csv_header.argtypes = [ctypes.c_void_p]
        lib.dmv_csv_copy.restype = None
        lib.dmv_csv_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.dmv_csv_close.restype = None
        lib.dmv_csv_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def read_csv_native(path: str) -> Tuple[List[str], np.ndarray]:
    """(header fields, (rows, cols) float64 matrix) of one CSV; NaN for an
    empty or non-numeric field.  Raises ``FileNotFoundError`` for a missing
    file and ``ValueError`` for one the loader refuses (empty, or a row
    wider than its header)."""
    lib = _load_lib()
    handle = lib.dmv_csv_open(os.fsencode(path))
    if not handle:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raise ValueError(f"{path}: the CSV loader cannot parse it (an empty file, or "
                         "a row wider than its header)")
    try:
        rows = lib.dmv_csv_rows(handle)
        cols = lib.dmv_csv_cols(handle)
        header = lib.dmv_csv_header(handle).decode("utf-8", "replace")
        out = np.empty((rows, cols), np.float64)
        lib.dmv_csv_copy(handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return header.split(","), out
    finally:
        lib.dmv_csv_close(handle)


# parse cache: the pipeline reads each CSV several times (start conditions,
# human extraction, THW, …); keyed by (path, mtime, size) so edits
# invalidate.  Each read_csv call returns a Frame over a COPY of the cached
# matrix, so a caller that writes into its Frame cannot corrupt the cache.
_parse_cache: dict = {}
_PARSE_CACHE_MAX = 512


def read_csv(path: str) -> Frame:
    """The :class:`Frame` of one CSV (``csv_io.read_csv`` :106 of the JAX
    package, pandas' naming of blank header fields included)."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    # single .get: a check-then-index pair races the clear()-based
    # eviction under concurrent read_csv calls (KeyError)
    entry = _parse_cache.get(key)
    if entry is None:
        names, data = read_csv_native(path)
        # pandas naming convention for blank header fields
        names = [n if n.strip() else f"Unnamed: {i}" for i, n in enumerate(names)]
        entry = (names, data)
        if len(_parse_cache) >= _PARSE_CACHE_MAX:
            _parse_cache.clear()
        _parse_cache[key] = entry
    names, data = entry
    return Frame(names, data.copy())
