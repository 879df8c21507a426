"""P3 (the cache probe's decoy) and the port's cache probe, on the CPU.

P3's plain version, ``x * 2.0 + 1.0``, is held bit for bit against the body
of JAX's ``scripts/cache_probe.py::_decoy`` run as a ``pl.pallas_call`` in
interpret mode with VMEM specs.  The body is restated here: ``_decoy`` is
a closure that only lowers, and importing JAX's probe re-executes the
process (``ensure_deterministic_hash_seed`` at import).  The CUDA kernel is
held against the plain version on the card (chip_smoke.py and
tests/test_torch_auto_card.py).  The probe's nvcc rounds run only on the
card's machine; here its spec table, its verdicts and the library key are
checked with the compiler stood in for.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch.ops import _build
from defensive_model_vae_tpu_torch.ops import cache_decoy
from defensive_model_vae_tpu_torch.scripts import cache_probe


def test_p3_plain_matches_pallas_interpret():
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def k(x_ref, o_ref):  # scripts/cache_probe.py:105-106
        o_ref[:] = x_ref[:] * 2.0 + 1.0

    x = np.random.default_rng(0).standard_normal(cache_decoy.SHAPE).astype(np.float32) * 1e3
    want = np.asarray(pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct(cache_decoy.SHAPE, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(jnp.asarray(x)))
    before = cache_decoy.decoy.launches
    got = cache_decoy.decoy(torch.tensor(x))
    assert cache_decoy.decoy.launches == before
    assert np.array_equal(got.numpy(), want)


def test_p3_refusals():
    with pytest.raises(ValueError, match="float32"):
        cache_decoy.decoy(torch.zeros(cache_decoy.SHAPE, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cache_decoy.decoy(torch.zeros((128, 256))[:, ::2])
    with pytest.raises(ValueError, match="CUDA or"):
        cache_decoy.decoy(torch.zeros(cache_decoy.SHAPE, device="meta"))


def test_p3_checks_dtype_then_device_then_contiguity():
    """The cheapest check first: a float64 tensor that is also non-contiguous
    and on another device is refused for its dtype; a float32 one for its
    device before its layout."""
    odd = torch.zeros((128, 256), dtype=torch.float64, device="meta")[:, ::2]
    with pytest.raises(ValueError, match="float32"):
        cache_decoy.decoy(odd)
    with pytest.raises(ValueError, match="CUDA or"):
        cache_decoy.decoy(odd.float())


def test_p3_on_the_cpu_builds_and_loads_nothing(monkeypatch):
    """On CPU tensors the wrapper runs its plain version and never reaches
    the build (there is no nvcc here) nor binds the C function."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_start_build", refuse)
    loaded = dict(_build._LOADED)
    x = torch.arange(7.0)[1:]  # contiguous, 4 bytes past its storage's start
    assert torch.equal(cache_decoy.decoy(x), x * 2.0 + 1.0)
    assert _build._LOADED == loaded and cache_decoy._launch is None


def test_p3_build_names_missing_python_headers(monkeypatch, tmp_path):
    """P3's launch object includes Python.h: where the headers are missing,
    the build stops before nvcc starts, with a message that names them."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc stand-in")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "PY_INCLUDE", str(tmp_path / "include"))

    def refuse(*a, **k):
        raise AssertionError("nvcc started")

    monkeypatch.setattr(_build.subprocess, "Popen", refuse)
    with pytest.raises(RuntimeError, match=r"Python\.h.*development headers"):
        _build._start_build("cache_decoy")


def test_probe_specs_name_the_objects_that_serve_them():
    """JAX's four specs, each served by an object of ``_build.KERNELS``: K1's
    manual object, K3's production object for both noise modes, K3's
    f32_acts autodiff object."""
    names = [n for n, _, _ in cache_probe.SPECS]
    assert names == ["fused_whole", "scale_hbm_manual", "scale_prng_manual", "scale_prng_auto"]
    objs = {n: cache_probe.object_name((lib, i)) for n, lib, i in cache_probe.SPECS}
    assert objs["fused_whole"] == "fused_trainer.cu"
    assert objs["scale_hbm_manual"] == objs["scale_prng_manual"] == "fused_scale.cu"
    assert objs["scale_prng_auto"] == "fused_scale_auto.cu -DKS_AUTO_MODE=1"
    assert len(cache_probe.objects()) == 3


def test_probe_compare_reads_verdicts(tmp_path, monkeypatch):
    """Equal cubins are deterministic and context-stable; where the bytes
    differ the SASS decides, and its verdicts are JAX's words."""
    def cubin(name, data):
        p = tmp_path / name
        p.write_bytes(data)
        return p

    same = ("fused_trainer", 0)
    drift = ("fused_scale", 0)
    paths = {same: {r: cubin(f"s{r}", b"abc") for r in ("A", "A2", "B")},
             drift: {"A": cubin("dA", b"x1"), "A2": cubin("dA2", b"x2"), "B": cubin("dB", b"x3")}}
    sass = {"dA": b"code", "dA2": b"code", "dB": b"other"}
    monkeypatch.setattr(cache_probe, "_sass", lambda p: sass[p.name])
    rows = cache_probe.compare(paths)
    assert rows[same]["compared"] == "cubin"
    assert (rows[same]["determinism"], rows[same]["context"]) == ("deterministic",
                                                                    "context-stable")
    assert rows[drift]["compared"] == "sass"
    assert (rows[drift]["determinism"], rows[drift]["context"]) == ("deterministic",
                                                                      "CONTEXT-DEPENDENT")
    assert cache_probe.verdicts("a", "b", "a") == ("NONDETERMINISTIC-IN-CONTEXT",
                                                   "context-stable")


def test_probe_builds_with_the_build_flags(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = cache_probe._cubin_cmd(("fused_scale", cache_probe.SPECS[3][2]),
                                 pathlib.Path("o.cubin"))
    assert cmd[:1 + len(_build.NVCC_FLAGS)] == ["nvcc", *_build.NVCC_FLAGS]
    assert "-DKS_AUTO_MODE=1" in cmd and "-cubin" in cmd
    assert cmd[-1].endswith("csrc/fused_scale_auto.cu")


def test_probe_refuses_without_cuda():
    with pytest.raises(RuntimeError, match="on the card"):
        cache_probe.run(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="on the card"):
        cache_probe.Probe().decoy(torch.device("cpu"))


def test_library_key_names_the_compiler_and_needs_no_hash_seed(monkeypatch):
    """``_lib_path`` hashes nvcc's version with the sources and flags: a
    toolkit change gives another library; the same compiler the same key
    in every process, whatever its hash seed."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.9")
    a = _build._lib_path("cache_decoy")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 13.0")
    b = _build._lib_path("cache_decoy")
    assert a != b and a.name.startswith("libcache_decoy_")
    script = textwrap.dedent("""
        from defensive_model_vae_tpu_torch.ops import _build
        _build.nvcc_version = lambda: "release 12.9"
        print(_build._lib_path("cache_decoy").name)
    """)
    names = {subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO_ROOT),
                                     PYTHONHASHSEED=seed), check=True).stdout.strip()
             for seed in ("1", "2")}
    assert names == {a.name}


def test_probe_close_stops_what_runs_and_removes_its_directory():
    """A probe abandoned mid-round (a failed phase of chip_smoke.py) leaves
    no compiler running and no cubins behind: ``close`` kills and reaps."""
    import time

    probe = cache_probe.Probe(5.0)
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    probe.started["A"] = ([(("fused_trainer", 0), probe.root / "0.cubin", proc)],
                          time.perf_counter())
    root = probe.root
    assert root.is_dir()
    probe.close()
    assert proc.poll() is not None and not root.exists()
