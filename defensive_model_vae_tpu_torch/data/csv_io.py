"""CSV input through the native C++ loader, and CSV output, without pandas.

Port of ``defensive_model_vae_tpu/data/csv_io.py``.  ``read_csv`` parses a
CARLA log CSV with the mmap + ``std::from_chars`` loader in
``native/csvloader.cpp`` and returns a :class:`Frame`: the column names over
one float64 matrix, with the column access, masks, row slices and column
assignment the scenario predicates, the extraction code, the SUT write-back
and the surrogate metrics use.  ``write_csv`` writes a ``Frame`` back, each
value its shortest ``repr``.

The loader is built on first use with ``g++ -O2 -std=c++17 -fPIC -shared``
into ``defensive_model_vae_tpu_torch/build/``, named by a SHA-256 of the
source, the flags and ``g++ --version`` (``_native.py``, as
``ops/_build.py`` names its libraries), and bound with ctypes.  There is
no fallback: a loader that does not build or load raises with the
compiler's output, and a file the loader cannot parse raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import _native

_PKG_ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_ROOT.parent / "native" / "csvloader.cpp"
BUILD_DIR = _PKG_ROOT / "build"
CXX = "g++"

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

    def assign(self, **columns) -> "Frame":
        """A new Frame with these columns: each replaces the column of its
        name, or is appended after the others (pandas' ``assign``)."""
        data, names = self.data.copy(), list(self.columns)
        extra = []
        for name, values in columns.items():
            col = np.broadcast_to(np.asarray(values, np.float64), (len(self),))
            if name in self._index:
                data[:, self._index[name]] = col
            else:
                names.append(name)
                extra.append(col)
        if extra:
            data = np.column_stack([data, *extra])
        return Frame(names, data)


def library_path() -> pathlib.Path:
    """Where the loader for this source, these flags and this compiler lives."""
    return _native.library_path(SOURCE, "libdmvcsv", BUILD_DIR, CXX, "the CSV loader")


def build() -> pathlib.Path:
    """Build the loader for the current source unless it is built already;
    → the library's path.  Raises with the compiler's output on failure."""
    return _native.build(SOURCE, "libdmvcsv", BUILD_DIR, CXX, "the CSV loader")


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


def csv_text(columns: Sequence[str], rows: np.ndarray) -> str:
    """A CSV of these columns and (rows, cols) values: each value its shortest
    ``repr``, which parses back to the same float64, and NaN an empty field,
    as pandas writes it."""
    def cell(v: float) -> str:
        return "" if v != v else repr(v)

    cols = []
    for c in np.asarray(rows, np.float64).reshape(-1, len(columns)).T.tolist():
        if c and c.count(c[0]) == len(c):  # a constant column: format it once
            cols.append([cell(c[0])] * len(c))
        else:
            cols.append([cell(v) for v in c])
    return "\n".join([",".join(columns)] + [",".join(r) for r in zip(*cols)]) + "\n"


def write_csv(path, frame: Frame) -> None:
    """Write a :class:`Frame` as :func:`csv_text` does (no index column)."""
    with open(path, "w") as f:
        f.write(csv_text(frame.columns, frame.data))
