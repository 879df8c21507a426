"""g++ builds of the repo's native C++ sources for the port.

A source under ``native/`` (the CSV loader, the DNDA spline kernels) is built
on first use with ``g++ -O2 -std=c++17 -fPIC -shared`` into
``defensive_model_vae_tpu_torch/build/``, named by a SHA-256 of the source,
the flags and ``g++ --version`` (as ``ops/_build.py`` names its libraries),
and never into ``native/``.  There is no fallback: a source that does not
build raises with the compiler's output, and a missing compiler raises.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path(source: pathlib.Path, stem: str, build_dir: pathlib.Path, cxx: str,
                 what: str) -> pathlib.Path:
    """Where the library of ``source`` built by ``cxx`` with these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{what} needs a C++ compiler ({cxx}): {e}") from e
    h.update(version.encode())
    h.update(pathlib.Path(source).read_bytes())
    return pathlib.Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path, stem: str, build_dir: pathlib.Path, cxx: str,
          what: str) -> pathlib.Path:
    """Build ``source`` unless its library is built already; → the library's
    path.  Raises with the compiler's output on failure."""
    out = library_path(source, stem, build_dir, cxx, what)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a half-written .so
    return out
