"""The traced part of a ``--trace 1`` run: torch.profiler over the card,
and the harness's own host spans beside it.

A driver calls :meth:`Tracer.begin` before the first unit of work it
traces and :meth:`Tracer.end` after the last; the rest of its window runs
untraced.  Host spans (:meth:`Tracer.span`) are taken on ``time.time_ns``,
the clock the profiler's events carry, so an idle gap on the card is named
by the harness span the host was in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Tuple


@dataclasses.dataclass
class TraceResult:
    """What one traced stretch of a window holds (times in ns)."""
    t0: int
    t1: int
    events: List[Tuple[str, int, int]]      # device operations: (name, start, end)
    spans: List[Tuple[str, int, int]]       # the harness's host spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the window."""
        out = []
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_percent(self):
        """The share of the window, in %, in which no operation ran on the
        card; None where nothing was traced."""
        if self.window_s <= 0 or not self.events:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def busy_between(self, t0: int, t1: int) -> float:
        """Seconds of the union in which the card was busy within [t0, t1]."""
        return sum(max(0, min(e, t1) - max(s, t0)) for s, e in self.busy_intervals()) / 1e9

    def spans_named(self, suffix: str):
        return [(s, e) for n, s, e in self.spans if n.endswith(suffix)]

    def op_seconds(self, match=None) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.events if match is None or match(n)) / 1e9

    def op_count(self, match=None) -> int:
        return sum(1 for n, _, _ in self.events if match is None or match(n))

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e in self.events:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10):
        """The longest stretches with nothing on the card, each named by the
        innermost harness span around its midpoint."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) // 2
            inside = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            label = max(inside, key=lambda sp: sp[1])[0] if inside else "outside the harness's spans"
            out.append([label, (e - s) / 1e9])
        return out


class Tracer:
    """Profiles the stretch between :meth:`begin` and :meth:`end` when
    enabled; otherwise every call is a no-op."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self._t0 = self._t1 = None
        self.spans: List[Tuple[str, int, int]] = []

    def _on_card(self) -> bool:
        return self.device is not None and str(self.device).startswith("cuda")

    def _sync(self):
        import torch

        if self._on_card():
            torch.cuda.synchronize(self.device)

    def _profile(self):
        """A profiler over the card (the CPU's operators in a dry run on the CPU)."""
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if self._on_card()
                                   else ProfilerActivity.CPU])

    def warm(self) -> None:
        """One empty profiler session: a process's first one starts slowly,
        and that start belongs to set-up, not to the traced stretch."""
        if not self.enabled:
            return
        with self._profile():
            pass

    @property
    def active(self) -> bool:
        return self._prof is not None and self._t1 is None

    def begin(self) -> None:
        if not self.enabled or self._t0 is not None:
            return
        self._sync()
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def end(self) -> None:
        if not self.active:
            return
        self._sync()
        self._t1 = time.time_ns()
        self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the harness (recorded only while tracing)."""
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def result(self):
        """The traced stretch as a :class:`TraceResult`, or None."""
        if self._prof is None or self._t1 is None:
            return None
        kind = "CUDA" if self._on_card() else "CPU"
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith(kind) and e.duration_ns() > 0]
        return TraceResult(self._t0, self._t1, events, list(self.spans))
