"""The program's spans (``utils/profiling.py``) on the CPU.

Off (no :func:`recording`), a span is one shared no-op that makes no CUDA
event; on, it records its host times and its parent on its own thread.  The
port opens spans where its work happens (the tracker's capture and replay
loop, the data-parallel tier's epochs, a kernel's build); ``trace_to``
writes them beside its profiler trace.
"""

import json
import pathlib
import re
import threading
import types

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.utils import profiling
from defensive_model_vae_tpu_torch.utils.profiling import recording, span, trace_to

PKG = pathlib.Path(profiling.__file__).resolve().parent.parent
# the spans the port opens, by module (names, not counts)
PROGRAM_SPANS = {
    "control/mpc.py": {"mpc.capture", "mpc.replays"},
    "ops/fused_scale.py": {"fused_train_scale_dp.k4", "fused_train_scale_dp.allreduce"},
    "ops/_build.py": {"build.{name}"},
}


def test_off_a_span_is_one_shared_no_op_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a span outside recording() made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    card = torch.device("cuda", 0)
    first, second = span("a"), span("b", device=card)
    assert first is second is profiling._NO_SPAN
    with span("a"), span("b", device=card):
        pass
    with pytest.raises(KeyError):  # the no-op lets an exception pass on
        with span("a"):
            raise KeyError("off")
    with recording() as rec:
        with span("inside"):
            pass
        with pytest.raises(KeyError):
            with span("raised"):
                raise KeyError("on")
    assert [r.name for r in rec.spans] == ["inside", "raised"]
    assert span("after") is profiling._NO_SPAN
    assert profiling._sink is None


def test_parents_follow_each_threads_nesting():
    """A span's parent is the span open around it on its own thread; a span
    open on another thread is never a parent."""
    seen = threading.Event()
    go = threading.Event()

    def other():
        with span("thread.outer"):
            seen.set()
            go.wait(10)
            with span("thread.inner"):
                pass

    with recording() as rec:
        with span("main.outer"):
            t = threading.Thread(target=other)
            t.start()
            assert seen.wait(10)
            with span("main.child"):
                go.set()
                with span("main.grandchild"):
                    pass
            with span("main.child"):
                pass
            t.join(10)
    assert not t.is_alive()
    by = {}
    for r in rec.spans:
        by.setdefault(r.name, []).append(r)
    assert len(rec.spans) == 6 and len({r.id for r in rec.spans}) == 6
    outer, (child1, child2) = by["main.outer"][0], by["main.child"]
    assert outer.parent is None
    assert child1.parent == child2.parent == outer.id
    assert by["main.grandchild"][0].parent == child1.id
    t_outer, t_inner = by["thread.outer"][0], by["thread.inner"][0]
    assert t_outer.parent is None and t_inner.parent == t_outer.id
    assert [r.start_ns for r in rec.spans] == sorted(r.start_ns for r in rec.spans)
    for r in rec.spans:
        assert r.start_ns <= r.end_ns and r.device_ms is None


def test_a_recording_inside_another_hands_its_spans_on():
    with recording() as outer:
        with span("a"):
            with recording() as inner:
                with span("b"):
                    pass
        with span("c"):
            pass
    assert [r.name for r in inner.spans] == ["b"]
    assert [r.name for r in outer.spans] == ["a", "b", "c"]
    assert outer.spans[1].parent == outer.spans[0].id


def test_no_program_span_takes_a_harness_name():
    """The names the port opens (found in its source) are the ones listed
    here, and none ends in a harness span's ending."""
    found = {}
    for path in PKG.rglob("*.py"):
        for name in re.findall(r'\bspan\(f?"([^"]+)"', path.read_text()):
            found.setdefault(str(path.relative_to(PKG)), set()).add(name)
    assert found == PROGRAM_SPANS
    for names in found.values():
        for name in names:
            assert not name.endswith(profiling.HARNESS_SUFFIXES), name


@pytest.mark.parametrize("suffix", profiling.HARNESS_SUFFIXES)
def test_a_harness_ending_is_refused_while_recording(suffix):
    assert span("mpc" + suffix) is profiling._NO_SPAN  # off: nothing is checked
    with recording() as rec:
        with pytest.raises(ValueError, match="harness"):
            span("mpc" + suffix)
    assert rec.spans == []


def test_a_span_on_the_cpu_has_no_device_time(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a span on the CPU made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with recording() as rec:
        with span("cpu.work", device=torch.device("cpu")):
            torch.ones(4).sum()
    (r,) = rec.spans
    assert r.name == "cpu.work" and r.device_ms is None and r.start_ns <= r.end_ns


def test_a_kernel_is_a_build_span_on_its_first_load_only(monkeypatch):
    """``ops/_build.py::load`` names a build or first load of a kernel's
    library; a load of a library already loaded records nothing."""
    from defensive_model_vae_tpu_torch.ops import _build

    class FakeLib:
        def __getattr__(self, fn):
            f = types.SimpleNamespace()
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_start_build", lambda name: None)
    monkeypatch.setattr(_build, "_lib_path", lambda name: f"lib{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    with recording() as rec:
        lib = _build.load("lu_solve")
        assert _build.load("lu_solve") is lib
    assert [r.name for r in rec.spans] == ["build.lu_solve"]
    for fn, (restype, argtypes) in _build.KERNELS["lu_solve"][1].items():
        assert getattr(lib, fn).restype is restype and getattr(lib, fn).argtypes == argtypes


def test_trace_to_writes_the_spans(tmp_path):
    with trace_to(str(tmp_path)):
        with span("outer"):
            with span("inner"):
                torch.ones(3).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [s["name"] for s in spans] == ["outer", "inner"]
    assert set(spans[0]) == {"name", "start_ns", "end_ns", "id", "parent", "device_ms"}
    assert spans[1]["parent"] == spans[0]["id"] and spans[0]["parent"] is None


def test_trace_to_without_a_directory_records_nothing():
    with trace_to(None):
        assert profiling._sink is None
        assert span("outer") is profiling._NO_SPAN


def test_the_dp_tier_records_two_spans_an_epoch():
    """``fused_train_scale_dp``'s epochs as spans (on the CPU: no device
    time), which ``parallel/worlds.py::dp_timed`` reads."""
    from defensive_model_vae_tpu_torch.ops.fused_scale import fused_train_scale_dp
    from defensive_model_vae_tpu_torch.parallel import worlds

    windows = np.cumsum(np.random.default_rng(0).normal(size=(24, 10, 3)), axis=1)
    with recording() as rec:
        fused_train_scale_dp(windows.astype(np.float32), epochs=3, tile=8,
                             compute_dtype=None, device="cpu")
    names = [r.name for r in rec.spans]
    assert names == ["fused_train_scale_dp.k4", "fused_train_scale_dp.allreduce"] * 3
    assert all(r.device_ms is None for r in rec.spans)
    assert not hasattr(fused_train_scale_dp, "epoch_events")
    assert "epoch_events" not in pathlib.Path(worlds.__file__).read_text()
