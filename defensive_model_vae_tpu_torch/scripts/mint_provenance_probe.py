"""Which edits and which moves of the checkout re-key a kernel library of
the port's build cache?

Port of the JAX package's ``scripts/mint_provenance_probe.py``:

    python -m defensive_model_vae_tpu_torch.scripts.mint_provenance_probe \\
        [--workdir DIR] [--no-build] [--out FILE]

JAX's probe found that a Mosaic kernel's lowered payload embeds the
absolute path and the line number of every source line on its trace, so a
docstring edit or another checkout path re-keys the persistent cache.
The port's cache is ``ops/_build.py``'s: a library is named by a SHA-256
of its compiler flags and defines, ``nvcc --version``'s output, and the
bytes of its sources and of the headers under ``csrc/`` (``_lib_path``).
The probe computes each library's key, without compiling, from copies of
the package, each key by the copy's own ``ops/_build.py`` (loaded from the
copy, so its ``csrc/`` is the copy's; ``nvcc --version`` is asked once, of
the one toolchain):

  A   a pristine copy at one path, its keys computed twice (two loads)
  B   the same copy with one comment line prepended to ``csrc/fused_scale.cu``
  C   a pristine copy at another path
  D   a pristine copy with one comment line prepended to
      ``ops/fused_scale.py`` (the edit of JAX's historical case)

It reports which libraries each change re-keys, and every flag or define
that enters a key and names an absolute path.  With a card (unless
``--no-build``) it also builds P3's small library (``cache_decoy``, two
objects) from copies A and C at once, then from A once more, and compares
the ``.so`` files' bytes and their device code (``cuobjdump -sass``): do
two paths, or two builds at one path, give the same library?
The copies live under ``--workdir`` (a new temporary directory by
default), which is removed at the end.  The result is printed as one JSON
line and written to ``--out`` only when given.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from ..ops import _build

PKG = _build.PKG_ROOT
COMMENT = "// mint-probe: one-line shift\n"
PY_COMMENT = "# mint-probe: one-line shift\n"
_LOADS = itertools.count()


def copy_package(dst: pathlib.Path) -> pathlib.Path:
    """A copy of the package (no build products, no caches) under ``dst``."""
    out = dst / PKG.name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(PKG, out, ignore=shutil.ignore_patterns("__pycache__", "build"))
    return out


def load_build(copy: pathlib.Path):
    """The copy's own ``ops/_build.py`` as a module of its own, asking
    ``nvcc --version`` through this process's (one toolchain)."""
    name = f"_mint_probe_build_{next(_LOADS)}"
    spec = importlib.util.spec_from_file_location(name, copy / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.nvcc_version = _build.nvcc_version
    return mod


def keys(copy: pathlib.Path):
    """{library: its key} as the copy computes them."""
    mod = load_build(copy)
    return {name: mod._lib_path(name).name for name in mod.KERNELS}


def absolute_flags():
    """Every flag or define that enters a key and names an absolute path."""
    flags = [("NVCC_FLAGS", f) for f in _build.NVCC_FLAGS]
    flags += [(f"{lib}: {src}", d) for lib, (objs, _) in _build.KERNELS.items()
              for src, defines in objs for d in defines]
    out = []
    for where, f in flags:
        path = f[2:] if f.startswith(("-I", "-L")) else f
        if os.path.isabs(path):
            out.append({"where": where, "flag": f,
                        "inside_checkout": pathlib.Path(path).is_relative_to(PKG.parent)})
    return out


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# a SASS instruction line of ``cuobjdump -sass``: "        /*0040*/  IMAD ..."
_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/")


def _sass_sha(lib: pathlib.Path):
    """The hash of the library's device code: the instruction lines that
    ``cuobjdump -sass`` lists (not its headers, which name the source nvcc
    was given), or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                       timeout=120, check=True)
    return _sha("\n".join(ln.strip() for ln in r.stdout.splitlines()
                          if _SASS_LINE.match(ln)).encode())


def build_decoy(copies, timeout=240.0):
    """Build P3's library from each copy (each copy's own ``_build``), all
    at once → [{"path", "so_sha", "sass_sha", "nvcc_s"}]."""
    mods = [load_build(c) for c in copies]
    started = [m._start_build("cache_decoy") for m in mods]
    out = []
    for m, s in zip(mods, started):
        if s is None:
            raise RuntimeError(f"{m.BUILD_DIR} already holds P3's library")
        _, secs = m._finish_build("cache_decoy", s, timeout)
        lib = m._lib_path("cache_decoy")
        out.append({"path": str(lib), "so_sha": _sha(lib.read_bytes()),
                    "sass_sha": _sass_sha(lib), "nvcc_s": secs})
    return out


def probe(workdir: pathlib.Path, build: bool):
    """The probe → its result dict (module docstring)."""
    a = copy_package(workdir / "a")
    c = copy_package(workdir / "cc")
    d = copy_package(workdir / "d")
    out = {"nvcc": _build.nvcc_version().strip().splitlines()[-1]}
    ka, ka2 = keys(a), keys(a)
    kc = keys(c)
    b = copy_package(workdir / "b")
    cu = b / "csrc" / "fused_scale.cu"
    cu.write_text(COMMENT + cu.read_text())
    kb = keys(b)
    py = d / "ops" / "fused_scale.py"
    py.write_text(PY_COMMENT + py.read_text())
    kd = keys(d)

    def rekeyed(k):
        return sorted(n for n in ka if k[n] != ka[n])

    out.update({
        "paths": {"a": str(a), "b": str(b), "c": str(c), "d": str(d)},
        "keys_pristine": ka,
        "a_deterministic_across_loads": ka == ka2,
        "comment_line_in_cu_rekeys": rekeyed(kb),
        "checkout_path_rekeys": rekeyed(kc),
        "comment_line_in_py_rekeys": rekeyed(kd),
        "absolute_flags_in_key": absolute_flags(),
    })
    if build:
        libs = build_decoy([a, c])
        shutil.rmtree(a / "build")  # then A once more, at the same path
        again = build_decoy([a])[0]
        out["decoy_builds"] = {"a": libs[0], "c": libs[1], "a_again": again}
        out["decoy_so_equal_across_paths"] = libs[0]["so_sha"] == libs[1]["so_sha"]
        out["decoy_so_equal_rebuilt_at_one_path"] = libs[0]["so_sha"] == again["so_sha"]
        out["decoy_sass_equal_across_paths"] = libs[0]["sass_sha"] == libs[1]["sass_sha"]
    out["conclusion"] = (
        "The key is a digest of file contents and flags: an edit to a kernel source "
        f"re-keys {rekeyed(kb)}; a move of the checkout re-keys {rekeyed(kc) or 'nothing'}; "
        f"an edit to a Python file re-keys {rekeyed(kd) or 'nothing'}.")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", help="where the copies go (default: a new temporary "
                                      "directory); removed at the end")
    ap.add_argument("--no-build", action="store_true",
                    help="compute the keys only; build nothing")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="mint_probe_"))
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        out = probe(workdir, build=not args.no_build)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"mint_provenance_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
