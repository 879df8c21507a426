"""Start a ``torch.distributed`` world of processes on one host.

``spawn_world(fn, world, backend, device)`` starts ``world`` processes
(start method ``spawn``), each of which joins one process group through a
``file://`` rendezvous in a fresh temporary directory (no TCP port, so
concurrent worlds never collide), reads the call from a file there, calls
``fn(device, *args, **kwargs)`` and hands its return value back through a
file.  The parent waits under its own
time limit: a rank that raises fails the call with that rank's traceback,
and a world that outlives the limit is terminated and raises
``TimeoutError``, so a broken rank never hangs its caller.

``start_world(world, backend, device)`` is the same in two steps: it
returns as soon as the processes are started, and their start-up (importing
torch, joining the group) runs while the caller does other work; the ranks
then wait, idle, until :meth:`World.submit` hands them the call, and
:meth:`World.result` collects what they return.  A rank whose
parent has gone exits instead of waiting.

``fn`` must be importable by name in a fresh interpreter (a module-level
function of an importable module): ``spawn`` re-imports its module in
every child.  The rank programs the port's checks run live in
:mod:`.worlds`.  Under ``torchrun`` none of this is needed: each process
calls ``create_mesh`` itself.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch.multiprocessing as mp

# this rank's clock (time.time()) when its target began, when it had joined
# the process group and when its call arrived: a rank program reads them to
# time start-up
rank_clock = {}

# how often a waiting rank looks for its call, in seconds
_POLL_S = 0.02


def _wait_for_call(path, parent):
    while not os.path.exists(path):
        if os.getppid() != parent:  # the parent is gone: no call will come
            raise SystemExit(1)
        time.sleep(_POLL_S)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_entry(rank, world, backend, device, store_dir, timeout_s, parent):
    rank_clock["entry"] = time.time()
    import torch
    import torch.distributed as dist

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(store_dir, 'rendezvous')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        rank_clock["joined"] = time.time()
        fn, args, kwargs = _wait_for_call(os.path.join(store_dir, "call.pkl"), parent)
        rank_clock["called"] = time.time()
        out = fn(device, *args, **kwargs)
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(store_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


# after a rank fails, the seconds the others get to end before they are
# terminated (a rank waiting in a collective for the failed one never ends)
_GRACE_S = 5.0


class World:
    """A started world (:func:`start_world`): its ranks start up, join their
    group and wait for the one call :meth:`submit` (or :meth:`run`) gives
    them."""

    def __init__(self, world: int, backend: str, device: str, timeout_s: float):
        self.world, self.timeout_s = world, timeout_s
        self.started = time.time()  # the ranks' clocks read against it
        self.store_dir = tempfile.mkdtemp(prefix="dmv_world_")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_entry, daemon=True,
                                  args=(r, world, backend, device, self.store_dir,
                                        timeout_s, os.getpid()))
                      for r in range(world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def run(self, fn, args=(), kwargs=None) -> list:
        """:meth:`submit` then :meth:`result`."""
        self.submit(fn, args, kwargs)
        return self.result()

    def submit(self, fn, args=(), kwargs=None) -> None:
        """Hand every rank the call ``fn(device, *args, **kwargs)``; the
        world's time limit runs from now."""
        # the call goes through a file, written whole before it appears: a
        # large argument pickled into each process's start-up pipe would
        # hold each start until the rank before had read it (importing torch
        # on the way)
        path = os.path.join(self.store_dir, "call.pkl")
        try:
            with open(path + ".part", "wb") as f:
                pickle.dump((fn, tuple(args), dict(kwargs or {})), f)
            os.replace(path + ".part", path)
        except BaseException:
            self.close()
            raise
        self.deadline = time.monotonic() + self.timeout_s

    def result(self) -> list:
        """Wait for the submitted call → the ranks' return values in rank
        order; the world ends with it."""
        try:
            return self._join()
        finally:
            self.close()

    def _join(self) -> list:
        procs, world, store_dir, deadline = (self.procs, self.world, self.store_dir,
                                             self.deadline)
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + _GRACE_S):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        errors = {r: open(os.path.join(store_dir, f"error_{r}.txt")).read()
                  for r in range(world)
                  if os.path.exists(os.path.join(store_dir, f"error_{r}.txt"))}
        if errors:
            r = min(errors)
            raise RuntimeError(f"rank {r} of {world} failed:\n{errors[r]}")
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after "
                               f"{self.timeout_s} s; terminated")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        out = []
        for r in range(world):
            with open(os.path.join(store_dir, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    def close(self) -> None:
        """End the ranks (killed if still running) and remove the world's
        directory."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.store_dir, ignore_errors=True)


def start_world(world: int, backend: str, device: str,
                timeout_s: float = 120.0) -> World:
    """Start ``world`` ranks, which join one group and wait for
    :meth:`World.submit`'s call.  The collectives' own timeout and the call's
    are both ``timeout_s``."""
    return World(world, backend, device, timeout_s)


def spawn_world(fn, world: int, backend: str, device: str, args=(), kwargs=None,
                timeout_s: float = 120.0):
    """Run ``fn(device, *args, **kwargs)`` on each of ``world`` ranks →
    the list of the ranks' return values, in rank order.

    The rendezvous, the call and the results live in a temporary directory,
    removed afterwards.  The collectives' own timeout and the join's are
    both ``timeout_s``."""
    return start_world(world, backend, device, timeout_s).run(fn, args, kwargs)
