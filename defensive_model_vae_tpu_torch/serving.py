"""Persistent local serving of the deployment path.

Port of ``defensive_model_vae_tpu/serving.py``.  The serve program
(``control.device_reference.make_serve_fn``: condition → sample →
reference → MPC, on the device) is wrapped in a long-lived local HTTP
endpoint, so every request reaches a warm program and a warm device.

The program runs at one fixed batch size and requests are padded up to it
(padding rows repeat the first request; a row's draws depend only on the
seed and its index, so padding never changes a real row).  A request
larger than the batch is refused with 400: the batch is a deployment
choice.

One process can host several models (e.g. the four scenario checkpoints:
``serve_checkpoint`` takes a ``{name: ckpt_dir}`` dict, the CLI's ``serve
--listen`` a repeated ``--ckpt NAME=DIR``); requests route by their
``"model"`` field.

Endpoints:

- ``GET /healthz`` → ``{"ok": true, "batch": B, "steps": N,
  "models": [...], "served": n, "rejected": n, "errors": n,
  "last_ms": x}`` (2xx / 4xx / 5xx counters and the last successful
  request's wall time)
- ``POST /serve`` with ``{"requests": [{"start_x", "start_y",
  "heading"?, "vx"?, "vy"?}, ...], "seed"?: int, "model"?: str}`` →
  ``{"model": str, "seed": int, "n": k, "states": (k, steps+1, 4),
  "controls": (k, steps, 2)}`` — states ``[x, y, θ, v]``, controls
  ``[accel, steer]``.  ``"model"`` is optional while one model is served,
  required with several.
- ``POST /generate`` — the same request, answered with the sampled
  ``{"trajectories": (k, T, 3)}`` global [t, x, y] (no MPC).

Rows whose solve diverges come back as ``null`` with their indices in the
response's ``"invalid"``; their batchmates are unaffected.  ``"format":
"npz"`` in a POST body answers with a binary ``np.savez`` payload
(``application/octet-stream``; arrays ``model``/``seed``/``n``/``invalid``
and the route's outputs, raw float32, diverged rows as they are).

The server is single-threaded: requests serialize through the one device
anyway, and one dispatch queue keeps latency honest.

Data parallel (``mesh=``, ``cli.py serve --data-parallel``): every rank of
a ``parallel.create_mesh`` world calls :func:`serve_checkpoint`.  Rank 0
builds and returns the server; each request it takes goes to the other
ranks by ``torch.distributed.broadcast_object_list``, every rank runs its
block of the batch, and the blocks are gathered.  The other ranks wait in
:func:`serve_worker_loop` until the server closes (``server_close``
broadcasts the stop message), and :func:`serve_checkpoint` returns None
there.
"""

from __future__ import annotations

import io
import json
import secrets
import sys
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device

# request defaults, shared with the CLI's one-shot arguments
_DEFAULTS = {"heading": 1.57, "vx": 0.0, "vy": 10.0}
# the serve program's MPC horizons (prediction, control)
SERVE_HORIZONS = (30, 20)
# request bodies are a few KB of floats; anything near this is abuse
_MAX_BODY_BYTES = 1 << 24
# the warm-up's steps (serve_checkpoint)
_WARM_STEPS = 4


def _parse_requests(rows, batch: int):
    """Validate a request list and pad it to the batch size (JAX :82).

    Returns (starts (B, 2) f32, inits (B, 5) f32, k); rows beyond k are
    copies of row 0 (dropped from the response)."""
    if not isinstance(rows, list) or not rows:
        raise ValueError("'requests' must be a non-empty list")
    if len(rows) > batch:
        raise ValueError(
            f"{len(rows)} requests exceed the compiled batch {batch}; "
            "split the call or restart the server with a larger --batch")
    starts = np.zeros((batch, 2), np.float32)
    inits = np.zeros((batch, 5), np.float32)
    for i, r in enumerate(rows):
        try:
            x, y = float(r["start_x"]), float(r["start_y"])
            extras = [float(r.get(k, v)) for k, v in _DEFAULTS.items()]
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                f"request {i}: 'start_x'/'start_y' (and optional "
                f"{sorted(_DEFAULTS)}) must be numbers") from None
        # finiteness of the float32 values the program sees: 1e200 is
        # finite in float64 and overflows the cast (the overflow is the
        # detection, so its warning is silenced)
        with np.errstate(over="ignore"):
            vals = np.array((x, y, *extras), np.float32)
        if not np.isfinite(vals).all():
            raise ValueError(f"request {i}: values must be finite in float32, got "
                             f"{[x, y, *extras]}")
        starts[i] = vals[:2]
        inits[i] = vals
    k = len(rows)
    starts[k:] = starts[0]
    inits[k:] = inits[0]
    return starts, inits, k


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_http_server(serve_fns, batch: int, num_steps: int, host: str = "127.0.0.1",
                     port: int = 0, generate_fns=None) -> HTTPServer:
    """Wrap ``serve_fn(seed, starts, inits)`` program(s) in an HTTPServer
    (JAX :124).

    ``serve_fns`` is one callable or a ``{name: callable}`` dict, routed by
    the request's ``"model"`` field: optional with one model, required
    with several.  ``generate_fns`` likewise holds ``gen(seed, starts)``
    samplers for ``/generate`` (501 for a model without one).

    ``port=0`` binds an ephemeral port (``server.server_address``).  The
    caller owns the lifecycle: ``serve_forever()``, then ``shutdown()``
    and ``server_close()``.  ``server.serve_fns`` and
    ``server.generate_fns`` are the dicts the handler reads at each
    request."""
    if callable(serve_fns):
        serve_fns = {"default": serve_fns}
    if not serve_fns:
        raise ValueError("need at least one serve_fn")
    if callable(generate_fns):
        generate_fns = {"default": generate_fns}
    generate_fns = generate_fns or {}
    model_names = sorted(serve_fns)
    # single-threaded, so plain dict updates are safe; 'rejected' counts
    # 4xx refusals, 'errors' 5xx failures
    stats = {"served": 0, "rejected": 0, "errors": 0, "last_ms": None}

    class Handler(BaseHTTPRequestHandler):
        # a client that stalls mid-body must not wedge the server
        timeout = 30

        def log_message(self, fmt, *args):  # noqa: D102 (no per-request log)
            pass

        def _bytes(self, body: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload) -> None:
            # every error response passes here, so the counters miss none
            if code >= 500:
                stats["errors"] += 1
            elif code >= 400:
                stats["rejected"] += 1
            # strict JSON: non-finite rows are nulled before this
            body = json.dumps(payload, allow_nan=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._json(200, {"ok": True, "batch": batch, "steps": num_steps,
                                 "models": model_names, **stats})
            else:
                self._json(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/serve", "/generate"):
                return self._json(404, {"error": f"unknown path {self.path!r}"})
            try:
                n = int(self.headers.get("Content-Length") or 0)
                if n > _MAX_BODY_BYTES:
                    return self._json(413, {"error": f"body exceeds {_MAX_BODY_BYTES} bytes"})
                try:
                    raw = self.rfile.read(n)
                except OSError:  # the client stalled past the socket timeout
                    self.close_connection = True
                    return
                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                name = req.get("model")
                if name is None:
                    if len(serve_fns) > 1:
                        raise ValueError(f"'model' is required when serving several "
                                         f"models: {model_names}")
                    name = model_names[0]
                if name not in serve_fns:
                    raise ValueError(f"unknown model {name!r}; serving {model_names}")
                if self.path == "/generate" and name not in generate_fns:
                    return self._json(
                        501, {"error": "generation route not configured for "
                                       f"{name!r} (build the server with "
                                       "generate_fns, e.g. via serve_checkpoint)"})
                starts, inits, k = _parse_requests(req.get("requests"), batch)
                seed = req.get("seed")
                if seed is None:
                    # entropy default: two anonymous requests draw afresh
                    seed = secrets.randbelow(1 << 31)
                seed = int(seed)
                # the JAX server's bound (its PRNGKey folds seeds to 32 bits)
                if not 0 <= seed < 1 << 32:
                    raise ValueError(f"seed {seed} outside [0, 2**32)")
                fmt = req.get("format", "json")
                if fmt not in ("json", "npz"):
                    raise ValueError(f"unknown format {fmt!r} (expected 'json' or 'npz')")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            t0 = time.perf_counter()
            try:
                payload = {"model": name, "seed": seed, "n": k}
                if self.path == "/generate":
                    outputs = {"trajectories": _numpy(generate_fns[name](seed, starts))[:k]}
                else:
                    states, controls = serve_fns[name](seed, starts, inits)
                    outputs = {"states": _numpy(states)[:k], "controls": _numpy(controls)[:k]}
                # per-row divergence: one degenerate draw must not poison
                # its batchmates; its row comes back null, listed in 'invalid'
                bad = np.zeros(k, bool)
                for arr in outputs.values():
                    bad |= ~np.isfinite(arr.reshape(k, -1)).all(axis=1)
                invalid = np.nonzero(bad)[0]
                if fmt == "npz":
                    bio = io.BytesIO()
                    np.savez(bio, model=name, seed=seed, n=k, invalid=invalid, **outputs)
                    body = bio.getvalue()
                else:
                    if bad.any():
                        payload["invalid"] = invalid.tolist()
                    for field, arr in outputs.items():
                        payload[field] = [None if b else row.tolist()
                                          for row, b in zip(arr, bad)]
            except Exception as e:  # a JSON 500, not a dropped connection
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            stats["served"] += 1
            stats["last_ms"] = round(1e3 * (time.perf_counter() - t0), 2)
            if fmt == "npz":
                self._bytes(body)
            else:
                self._json(200, payload)

    server = HTTPServer((host, port), Handler)
    server.serve_fns, server.generate_fns = serve_fns, generate_fns
    return server


def _load_for_serving(ckpt_dir: str, device="cuda"):
    from .train.checkpoint import load_checkpoint, require_cvae_config

    params, cfg, manifest = load_checkpoint(ckpt_dir, resolve_device(device))
    require_cvae_config(cfg, "serving")
    return params, cfg, manifest


def _serve_fn_from(params, cfg, manifest, num_steps: int, dt: float, mesh=None):
    from .control import MPCConfig
    from .control.device_reference import make_serve_fn

    P, M = SERVE_HORIZONS
    mpc = MPCConfig(prediction_horizon=P, control_horizon=M, dt=dt)
    return make_serve_fn(params, cfg, mpc, num_steps=num_steps,
                         offset_mode=manifest.get("offset_mode", True), mesh=mesh)


def _generate_fn_from(params, cfg, manifest, mesh=None):
    from .generate import make_generate_fn

    return make_generate_fn(params, cfg, manifest.get("offset_mode", True), mesh=mesh)


def build_serve_fn(ckpt_dir: str, num_steps: int, dt: float, device="cuda", mesh=None):
    """Checkpoint → serve program on ``device`` (the one construction the
    one-shot CLI and the HTTP server share); ``mesh`` splits its batch over
    the data axis (on the mesh's device)."""
    dev = mesh.device if mesh is not None else device
    return _serve_fn_from(*_load_for_serving(ckpt_dir, dev), num_steps, dt, mesh=mesh)


def build_generate_fn(ckpt_dir: str, device="cuda", mesh=None):
    """Checkpoint → batched sampler ``gen(seed, starts) → (B, T, D)``
    global [t, x, y] trajectories on ``device``, honouring the manifest's
    ``offset_mode``; ``mesh`` splits the batch as the serve program's."""
    dev = mesh.device if mesh is not None else device
    return _generate_fn_from(*_load_for_serving(ckpt_dir, dev), mesh=mesh)


def _dispatching(fns, route: str):
    """Rank 0's programs: each call first sends (route, name, args) to the
    other ranks, then runs its own block."""
    import torch.distributed as dist

    def wrap(name, fn):
        def call(seed, *args):
            dist.broadcast_object_list([(route, name, seed, *args)], src=0)
            return fn(seed, *args)
        return call

    return {name: wrap(name, fn) for name, fn in fns.items()}


def serve_worker_loop(serve_fns, generate_fns) -> int:
    """A rank other than 0 of a data-parallel server: run each request rank
    0 broadcasts, on this rank's block, until the stop message (None).
    → the number of requests run.

    A request that fails is logged and the loop goes on: the programs fail
    a call on every rank at once (``parallel.mesh.run_block``), so rank 0
    answers it with a 500 and every rank meets at the next broadcast."""
    import torch.distributed as dist

    fns = {"serve": serve_fns, "generate": generate_fns}
    done = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return done
        route, name, seed, *args = box[0]
        try:
            fns[route][name](seed, *args)
        except Exception as e:  # rank 0 answers it; the group stays in step
            print(f"serve rank {dist.get_rank()}: /{route} {name!r} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        done += 1


def serve_checkpoint(ckpt, batch: int, num_steps: int, dt: float = 0.02,
                     host: str = "127.0.0.1", port: int = 0,
                     warm_seed: Optional[int] = None, device="cuda",
                     mesh=None) -> Optional[HTTPServer]:
    """Build and warm the serve program(s) of checkpoint(s) on ``device``,
    and return the server (JAX :385).

    ``ckpt`` is a checkpoint directory, or a ``{name: directory}`` dict to
    host several models behind one endpoint; each is loaded from disk
    once.  JAX's warm-up absorbs a compile; torch compiles nothing, so
    here each model's program and sampler run once at the full batch and
    ``_WARM_STEPS`` steps (entropy-seeded unless ``warm_seed`` pins it),
    which loads the device libraries (cuBLAS, the LU kernel), primes the
    caching allocator and, on the card, captures the tracker's step graph
    at the batch (``control/mpc.py``; keyed by the batch, not the step
    count), so that the first request replays it.

    ``mesh`` (``parallel.create_mesh`` over the whole world; the batch a
    multiple of its data axis): every rank calls this.  In a world over one
    rank, rank 0 gets the server, whose ``server_close`` stops the others,
    and the others run :func:`serve_worker_loop` until then and return
    None."""
    if not isinstance(ckpt, dict):
        ckpt = {"default": str(ckpt)}
    if mesh is not None:
        import torch.distributed as dist

        from .parallel.mesh import check_mesh

        check_mesh(mesh)
        device = mesh.device
        if mesh.size != dist.get_world_size():
            raise ValueError(f"a data-parallel server's mesh covers the world: "
                             f"{mesh.size} of {dist.get_world_size()} ranks")
        if batch % mesh.shape["data"]:
            raise ValueError(f"batch {batch} is not a multiple of the "
                             f"{mesh.shape['data']}-rank data axis")
    starts = np.zeros((batch, 2), np.float32)
    inits = np.tile(np.array([[0.0, 0.0, _DEFAULTS["heading"], 0.0, _DEFAULTS["vy"]]],
                             np.float32), (batch, 1))
    if warm_seed is None:
        warm_seed = secrets.randbelow(1 << 31)
    if mesh is not None:  # one warm seed, so every rank runs the same warm-up
        box = [warm_seed]
        dist.broadcast_object_list(box, src=0)
        warm_seed = box[0]
    serve_fns, generate_fns = {}, {}
    for name, d in ckpt.items():
        loaded = _load_for_serving(str(d), device)  # one disk load a model
        _numpy(_serve_fn_from(*loaded, min(num_steps, _WARM_STEPS), dt, mesh)(
            warm_seed, starts, inits)[0][-1])
        serve_fns[name] = _serve_fn_from(*loaded, num_steps, dt, mesh)
        gen = _generate_fn_from(*loaded, mesh)
        _numpy(gen(warm_seed, starts)[-1])
        generate_fns[name] = gen
    if mesh is None or mesh.size == 1:
        return make_http_server(serve_fns, batch, num_steps, host=host, port=port,
                                generate_fns=generate_fns)
    if dist.get_rank() != 0:
        serve_worker_loop(serve_fns, generate_fns)
        return None
    server = make_http_server(_dispatching(serve_fns, "serve"), batch, num_steps,
                              host=host, port=port,
                              generate_fns=_dispatching(generate_fns, "generate"))
    close = server.server_close
    stopped = []

    def server_close():
        if not stopped:
            stopped.append(True)
            dist.broadcast_object_list([None], src=0)
        close()

    server.server_close = server_close
    return server
