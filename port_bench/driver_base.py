"""What every driver shares, and the loop of the training drivers.

A driver is one kind of traffic (``drivers/<name>.py``, class ``Driver``).
The harness calls, in order: ``setup()`` (inputs, weights, warm-up),
``window(seconds)``, the readings (``end_to_end()``, ``counters()``,
``memory_peak_bytes()``, ``attempted()``, ``failed()``), ``release()`` (the program's state freed), then ``check()``,
which holds what the window produced to the plain reference and returns
``[{"name", "value", "limit"}]``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from . import seeds
from .reference import compare


def set_tf32(on: bool) -> None:
    """float32 products in TF32 (on) or in full float32 (off) from now on."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def tf32(on: bool):
    """float32 products in TF32 (on) or in full float32 (off) while this runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_tf32(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic, self.config = ctx.traffic, ctx.config
        self.device = ctx.device
        self._attempted = 0
        self._failed = 0

    # -- the harness's readings ------------------------------------------------
    def attempted(self) -> int:
        return self._attempted

    def failed(self) -> int:
        return self._failed

    def counters(self) -> dict:
        return {}

    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        if self.on_card():
            torch.cuda.synchronize(self.device)

    def memory_peak_bytes(self) -> int:
        if not self.on_card():
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_kind(self) -> str:
        if not self.on_card():
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def release(self) -> None:
        pass


class TrainingJobs(Driver):
    """Whole training jobs back to back over one seeded corpus, each from a
    fresh seeded start.

    A subclass gives ``make_inputs()`` (sets ``windows``, ``rows`` and
    ``epochs``), ``run_job(seed, epochs=None)`` → the program's (seed, leaves,
    per-epoch total losses) through the entry the window drives, and
    ``reference(seed, epochs, precision)`` → the plain reference's run of the
    first ``compare.FIRST_EPOCHS`` epochs of such a job.  Set-up warms the
    entry with one whole job, then runs the first steps through the same
    call: a job of ``compare.FIRST_EPOCHS`` epochs.  The window runs jobs
    until ``seconds`` have passed, and a ``--trace 1`` run at least until
    its traced jobs are done; the last one started finishes.
    The rate, reported under the traffic's ``rate_metric`` (each training
    cell its own, so that each has a bound of its own), is every completed
    job's windows × epochs over the time from the window's start to the
    last completion.  Traffic keys ``trace_jobs``: [first, count], the jobs a ``--trace 1`` run
    profiles; ``loss_epochs``: the epochs ``loss_gap`` covers.

    ``correct``: the losses of the first epochs of one window job, drawn
    from the seed, and the change of the parameters over the first-steps
    job, each against the reference (``reference/compare.py``)."""

    def setup(self) -> None:
        self.make_inputs()
        self.run_job(seeds.derive(self.ctx.seed, "warm"))
        self.first = self.run_job(seeds.derive(self.ctx.seed, "first"), compare.FIRST_EPOCHS)
        self.sync()

    def job_seed(self, j: int) -> int:
        return seeds.derive(self.ctx.seed, "job", j)

    def window(self, seconds: float) -> None:
        tracer = self.ctx.tracer
        first, count = self.traffic.get("trace_jobs", [1, 2])
        self.jobs = []  # (index, start, end, output)
        self.sync()
        t0 = time.perf_counter()
        j = 0
        while j == 0 or tracer.enabled and j < first + count \
                or time.perf_counter() - t0 < seconds:  # a traced run reaches its traced jobs
            if j == first:
                tracer.begin()
            job_seed = self.job_seed(j)
            self._attempted += 1
            s = time.perf_counter()
            try:
                with tracer.span(f"{self.name}.job"):
                    out = self.run_job(job_seed)
                    self.sync()
            except Exception as err:  # a job that fails is counted, not fatal
                self._failed += 1
                self.ctx.log(f"job {j} failed: {type(err).__name__}: {err}")
                out = None
            if out is not None:
                self.jobs.append((j, s, time.perf_counter(), out))
            if j == first + count - 1:
                tracer.end()
            j += 1
        tracer.end()
        self.t0 = t0

    def end_to_end(self) -> dict:
        done = len(self.jobs)
        if not done:
            raise RuntimeError("no job completed in the window")
        t_last = max(e for _, _, e, _ in self.jobs)
        return {self.traffic["rate_metric"]:
                done * self.rows * self.epochs / (t_last - self.t0)}

    def counters(self) -> dict:
        first, count = self.traffic.get("trace_jobs", [1, 2])
        traced = [j for j, _, _, _ in self.jobs if first <= j < first + count]
        return {"jobs": len(traced), "epochs": len(traced) * self.epochs,
                "rows": self.rows, "chips": self.ctx.chips, "job_epochs": self.epochs}

    def release(self) -> None:
        """Keeps the checked job's outputs alone: the job the reference
        follows, drawn from the seed among those that completed."""
        k = seeds.derive(self.ctx.seed, "check") % len(self.jobs)
        self.checked = self.jobs[k][3]
        self.jobs = []
        self._refs = {}
        if self.on_card():
            torch.cuda.empty_cache()

    def _reference(self, precision: str) -> dict:
        """The reference's runs at ``precision`` of the checked job's first
        epochs and of the first-steps job, computed once."""
        if precision not in self._refs:
            n = compare.FIRST_EPOCHS
            self._refs[precision] = {"window": self.reference(self.checked[0], self.epochs,
                                                              precision),
                                     "first": self.reference(self.first[0], n, precision)}
        return self._refs[precision]

    def program_outputs(self) -> dict:
        """The checked window job's losses and the first-steps job's leaves."""
        return {"losses": self.checked[2], "final": self.first[1]}

    def control_outputs(self) -> dict:
        """The reference in the program's place, one precision below the
        configuration's."""
        r = self._reference(self.config["control_precision"])
        return {"losses": r["window"]["losses"], "final": r["first"]["final"]}

    def fault_outputs(self, fault: str) -> dict:
        """The program run again with a fault planted: ``half_batch`` trains
        on the first half of the corpus, the mean taken over it alone."""
        if fault != "half_batch":
            raise ValueError(f"no fault {fault!r} in this cell")
        full, self.windows = self.windows, self.windows[: self.rows // 2]
        try:
            window_job = self.run_job(self.checked[0])
            first_job = self.run_job(self.first[0], compare.FIRST_EPOCHS)
        finally:
            self.windows = full
        return {"losses": window_job[2], "final": first_job[1]}

    def detail(self, outputs: dict = None) -> dict:
        """``compare.detail`` of the program's outputs (or ``outputs``)."""
        out = self.program_outputs() if outputs is None else outputs
        ref = self._reference(self.config["precision"])
        return compare.detail(out["losses"], ref["window"]["losses"], out["final"], ref["first"])

    def check(self, outputs: dict = None):
        """The program's outputs (or ``outputs`` in their place) against the
        reference at the configuration's precision."""
        out = self.program_outputs() if outputs is None else outputs
        ref = self._reference(self.config["precision"])
        return compare.training_checks(out["losses"], ref["window"]["losses"], out["final"],
                                       ref["first"], self.traffic["limits"],
                                       int(self.traffic.get("loss_epochs", compare.FIRST_EPOCHS)))
