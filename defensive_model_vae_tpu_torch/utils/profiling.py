"""Profiling: per-stage wall-clock timers, the program's spans, and the
torch device profiler hook.

Port of ``defensive_model_vae_tpu/utils/profiling.py``.  A stage timer whose
report is machine-readable, and a context manager that writes a
``torch.profiler`` trace (Chrome trace format, viewable in Perfetto or
``chrome://tracing``) where the JAX package wrote a ``jax.profiler`` one.

CUDA launches return before the device has run them, so a timer given a
CUDA device synchronises it (``torch.cuda.synchronize``) before it reads the
clock at a stage's start and end: a stage's seconds then hold the device
work it queued, as the JAX package's stages did by fetching their results.

Spans (:func:`span`) mark the program's phases where the work happens (the
tracker's capture and replay loop, the data-parallel tier's K4 call and
all-reduce, a kernel's build).  They synchronise nothing and copy nothing:
a span's times are the host's, on ``time.time_ns`` (the clock
``torch.profiler``'s events carry), and a span opened with a CUDA device
also records a CUDA event pair on that device's current stream, resolved to
device milliseconds only when the spans are collected.  They are recorded
only inside :func:`recording`; outside it a span is one shared no-op
context.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

# a benchmark harness names its own spans by these endings
# (port_bench/trace.py: TraceResult.spans_named); program spans never do
HARNESS_SUFFIXES = (".job", ".request", ".program")


class StageTimer:
    """Accumulates named stage durations.

    >>> timer = StageTimer()          # or StageTimer(device="cuda:0")
    >>> with timer.stage("train"):
    ...     ...
    >>> timer.report()          # {'train': {'seconds': ..., 'calls': 1}}
    """

    def __init__(self, device=None):
        self._acc: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._order: List[str] = []
        self._sync = None
        if device is not None:
            import torch

            dev = torch.device(device)
            if dev.type == "cuda":
                self._sync = lambda: torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync is not None:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._calls[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._calls[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"seconds": self._acc[name], "calls": self._calls[name]}
            for name in self._order
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


class _NoSpan:
    """The span outside :func:`recording`: one shared object, nothing read."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()
# the installed Sink, or None: recording off
_sink = None
# span ids, unique in the process; each thread's open spans
_ids = itertools.count()
_local = threading.local()


class Sink:
    """Where the spans of one :func:`recording` go: ``spans``, in start
    order once the block has ended."""

    def __init__(self):
        self.spans: List["SpanRecord"] = []

    def _collect(self) -> None:
        """Order the spans ended so far and resolve the device ones (their
        events are waited for, so call this after the caller's
        synchronise)."""
        spans = sorted(self.spans, key=lambda r: (r.start_ns, r.id))  # a copy
        for r in spans:
            if r._events is not None:
                r._events[1].synchronize()
                r.device_ms = r._events[0].elapsed_time(r._events[1])
                r._events = None
        self.spans = spans


class SpanRecord:
    """One recorded span, and the context that records it: ``name``,
    ``start_ns``/``end_ns`` (``time.time_ns``), ``id``, ``parent`` (the
    enclosing span's id on the same thread, or None) and ``device_ms`` (its
    time on the card's stream; None for a host span)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "device_ms",
                 "_sink", "_device", "_stream", "_events")

    def __init__(self, sink: Sink, name: str, device):
        if name.endswith(HARNESS_SUFFIXES):
            raise ValueError(f"span {name!r}: a program span does not end in "
                             f"{HARNESS_SUFFIXES} (the harness's names)")
        self.name, self.device_ms, self._stream, self._events = name, None, None, None
        self._sink, self._device = sink, device

    def __enter__(self):
        stack = _local.__dict__.setdefault("open", [])
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if getattr(self._device, "type", None) == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        _local.open.pop()
        self._sink.spans.append(self)
        return False

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("name", "start_ns", "end_ns", "id", "parent", "device_ms")}


def span(name: str, device=None):
    """A context marking one phase of the program as ``name``.

    Outside :func:`recording` it is a shared no-op (a few hundred ns, once
    or twice a request or an epoch).  Inside, it records the phase's host
    times and its parent (the enclosing span on this thread).  ``device``
    (a ``torch.device``): where it is a CUDA device, the span also records
    a CUDA event pair on that device's current stream."""
    sink = _sink
    if sink is None:
        return _NO_SPAN
    return SpanRecord(sink, name, device)


@contextlib.contextmanager
def recording():
    """Record the program's spans while the block runs: yields the
    :class:`Sink`, whose ``spans`` are complete once the block ends (device
    spans resolved then, so synchronise the card before the block ends).
    A span still open on another thread when the block ends is left out.
    A recording inside another one hands its spans on to the outer one
    too."""
    global _sink
    outer, sink = _sink, Sink()
    _sink = sink
    try:
        yield sink
    finally:
        _sink = outer
        sink._collect()
        if outer is not None:
            outer.spans.extend(sink.spans)


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present) written to ``<log_dir>/trace.json``, and the program's
    spans recorded in it (:func:`recording`) to ``<log_dir>/spans.json``
    (each span's name, start/end ns, id, parent and device ms); a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as rec:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump([r.as_dict() for r in rec.spans], f, indent=1)
