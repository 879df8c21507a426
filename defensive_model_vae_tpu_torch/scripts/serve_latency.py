"""Warm HTTP serving latency: batch 1, a full-batch throughput, and the
tail under concurrent clients.

Port of the JAX package's ``scripts/serve_latency.py``:

    python -m defensive_model_vae_tpu_torch.scripts.serve_latency \\
        [--ckpt results/checkpoints/sce1] [--steps 512] [--reps 7] \\
        [--throughput-batch 0] [--concurrency 8] [--load-requests 25] [--out FILE]

It stands up the endpoint of ``serving.serve_checkpoint`` (``cli.py serve
--listen``) on a committed checkpoint at batch 1 and ``--steps`` MPC steps
a request (dt 0.02) and times real POSTs against it, in one process:

- ``--reps`` requests each to ``/serve`` and ``/generate``, one at a time;
  beside each client wall time, the server's own (``/healthz``'s
  ``last_ms``), so the HTTP and JSON share is their difference;
- with ``--concurrency`` N > 0, N client threads of ``--load-requests``
  requests each against the one-threaded server: p50/p95/p99 are the
  queueing tail of one device behind one endpoint, and a failed request
  counts as an error;
- with ``--throughput-batch`` B > 0, a second server at batch B: three
  full-batch ``/serve`` requests answered as JSON, three as ``npz``.

Every request omits ``seed``, so the server draws it from OS entropy.
Each server is closed and its thread joined before the script returns,
whatever failed; every request has a time limit (REQUEST_TIMEOUT_S).  The
result carries the JAX script's keys, is printed as one JSON line and is
written to ``--out`` only when given.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import statistics
import sys
import threading
import time
import urllib.request

import numpy as np

from .._device import resolve_device
from ..pipeline import _git_sha
from ..serving import serve_checkpoint
from ._timing import device_name

REPO = pathlib.Path(__file__).resolve().parents[2]
CKPT = REPO / "results" / "checkpoints" / "sce1"
DT = 0.02
REQUEST_TIMEOUT_S = 120.0
# a plausible sce1 start (southbound corridor, ~8 m/s), as JAX's
ROWS = [{"start_x": -194.2, "start_y": 41.0, "heading": 1.57, "vx": 0.0, "vy": 8.0}]


def _post(base: str, path: str, payload: dict):
    """POST and parse the answer (JSON, or ``np.load`` for ``npz``): the
    parsing stays inside every timed window, for both formats."""
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as r:
        body = r.read()
    if payload.get("format") == "npz":
        z = np.load(io.BytesIO(body))
        return {"invalid": z["invalid"].tolist(), "n": int(z["n"])}
    return json.loads(body)


@contextlib.contextmanager
def serving(ckpt, batch, steps, dev):
    """A started server of ``ckpt`` at ``batch`` → (its base URL, its
    start-up seconds); shut down, closed and its thread joined on exit."""
    t0 = time.perf_counter()
    server = serve_checkpoint(str(ckpt), batch=batch, num_steps=steps, dt=DT, device=dev)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        yield f"http://{host}:{port}", startup_s
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


class Counter:
    """The rows every answer listed as diverged, and the rows answered."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = self.requests = 0

    def post(self, base, path, payload):
        """One counted request → its client milliseconds."""
        t = time.perf_counter()
        body = _post(base, path, payload)
        ms = 1e3 * (time.perf_counter() - t)
        with self.lock:
            self.rows += len(body.get("invalid", []))
            self.requests += body["n"]
        return ms


def _stats(client, srv):
    # the overhead is the median of each request's (client - server), not a
    # difference of medians
    return {"client_ms_median": statistics.median(client), "client_ms_min": min(client),
            "server_ms_median": statistics.median(srv),
            "http_overhead_ms_median": statistics.median(c - s for c, s in zip(client, srv))}


def _tail(base, counter, concurrency, load_requests):
    lat_ms, errors = [], []
    lock = threading.Lock()

    def client():
        for _ in range(load_requests):
            try:
                ms = counter.post(base, "/serve", {"requests": ROWS})
            except (OSError, ValueError) as e:  # refused, timed out, or a bad body
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                lat_ms.append(ms)

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=REQUEST_TIMEOUT_S * load_requests + 30)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("serve_latency: a client thread outlived its requests' limits")
    if not lat_ms:
        raise RuntimeError(f"serve_latency: every request under load failed: {errors[:3]}")
    qs = statistics.quantiles(lat_ms, n=100, method="inclusive") if len(lat_ms) > 1 \
        else [lat_ms[0]] * 99
    return {"concurrency": concurrency, "requests": len(lat_ms), "errors": len(errors),
            "error_examples": errors[:3], "p50_ms": statistics.median(lat_ms),
            "p95_ms": qs[94], "p99_ms": qs[98], "max_ms": max(lat_ms),
            "req_per_s": len(lat_ms) / wall}


def measure(ckpt=CKPT, steps=512, reps=7, throughput_batch=0, concurrency=8,
            load_requests=25, dev=None):
    """The measurement → the result dict (module docstring)."""
    counter = Counter()
    with serving(ckpt, 1, steps, dev) as (base, startup_s):
        def timed_route(path):
            client_ms, server_ms = [], []
            for _ in range(reps):
                client_ms.append(counter.post(base, path, {"requests": ROWS}))
                with urllib.request.urlopen(f"{base}/healthz",
                                            timeout=REQUEST_TIMEOUT_S) as r:
                    server_ms.append(json.loads(r.read())["last_ms"])
            return client_ms, server_ms

        serve = timed_route("/serve")
        generate = timed_route("/generate")
        tail = (_tail(base, counter, concurrency, load_requests)
                if concurrency > 0 else None)
    throughput = None
    if throughput_batch:
        B = throughput_batch
        with serving(ckpt, B, steps, dev) as (base2, _):
            rates = {}
            for fmt in ("json", "npz"):
                payload = {"requests": ROWS * B, "format": fmt}
                rates[fmt] = [B / (counter.post(base2, "/serve", payload) / 1e3)
                              for _ in range(3)]
        throughput = {"batch": B, "req_per_s_best": max(rates["json"]),
                      "req_per_s_median": statistics.median(rates["json"]),
                      "npz_req_per_s_best": max(rates["npz"]),
                      "npz_req_per_s_median": statistics.median(rates["npz"])}
    out = {"config": {"ckpt": str(ckpt), "batch": 1, "steps": steps, "reps": reps, "dt": DT},
           "backend": dev.type, "device": device_name(dev), "startup_s": startup_s,
           "serve": _stats(*serve), "generate": _stats(*generate),
           **({"serve_tail_under_load": tail} if tail else {}),
           **({"serve_throughput": throughput} if throughput else {}),
           "diverged_rows": counter.rows, "total_request_rows": counter.requests,
           "git_sha": _git_sha(),
           "notes": ["one warm process; every request draws its seed from OS entropy "
                     "on the server",
                     "startup_s: loading the checkpoint and the warm-up run, once a server"]}
    if tail:
        out["notes"].append("serve_tail_under_load: N client threads against the "
                            "one-threaded endpoint; p95/p99 are the queueing tail of one "
                            "device behind one endpoint, through HTTP")
    if throughput:
        out["notes"].append("serve_throughput: through HTTP with the answer parsed in the "
                            "timed window (json.loads or np.load)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--throughput-batch", type=int, default=0,
                    help="also a full-batch /serve throughput at this batch (0: skip)")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="client threads of the tail phase (0: skip)")
    ap.add_argument("--load-requests", type=int, default=25,
                    help="requests per client thread in the tail phase")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    if min(args.steps, args.reps) < 1 or min(args.throughput_batch, args.concurrency,
                                             args.load_requests) < 0:
        raise SystemExit("--steps and --reps must be at least 1, the others at least 0")
    out = measure(args.ckpt, args.steps, args.reps, args.throughput_batch, args.concurrency,
                  args.load_requests, resolve_device(args.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps({"serve_latency": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
