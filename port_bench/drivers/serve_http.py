"""One ``/serve`` endpoint (``serving.make_http_server``) over several
checkpoints, driven by one closed-loop client over HTTP on this host.

Set-up builds each model's serve program (``serving.build_serve_fn``) at
the traffic's batch and steps and the model's dt, wraps it in a span that
synchronises the card, starts the server on an ephemeral port in a thread
and sends one request a model (each program warmed, its tracker step
captured).  In the window the client sends the next request when the last
answer is in: each picks a model uniformly from the seed, ``batch`` start
rows drawn from that scenario's fixture windows (start point, first-step
heading and velocity) and a request seed, and asks for the answer in the
traffic's ``format`` (``npz``, the endpoint's binary arrays, or ``json``).
Latency is the client's, from send to parsed answer; a failed request
counts at ``timeout_s``.

Traffic keys: ``models`` ({name: {"ckpt", "fixture", "dt"}}), ``batch``,
``format``, ``steps``, ``timeout_s``, ``trace_requests`` ([first, count]),
``check_requests`` (answers held to the reference) and ``limits``.
"""

from __future__ import annotations

import io
import json
import statistics
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from .. import seeds
from ..driver_base import Driver as Base, tf32
from ..manifest import ROOT
from ..reference import serve as ref_serve


def start_rows(windows: np.ndarray, picks: np.ndarray) -> list:
    """Request rows from fixture windows [t, x, y]: the start point, the
    first step's heading and velocity."""
    w = windows[picks].astype(np.float64)
    v = (w[:, 1, 1:3] - w[:, 0, 1:3]) / np.maximum(w[:, 1, 0] - w[:, 0, 0], 1e-3)[:, None]
    return [{"start_x": float(r[0, 1]), "start_y": float(r[0, 2]),
             "heading": float(np.arctan2(vv[1], vv[0])), "vx": float(vv[0]),
             "vy": float(vv[1])} for r, vv in zip(w, v)]


def rows_arrays(rows):
    starts = np.array([[r["start_x"], r["start_y"]] for r in rows], np.float32)
    inits = np.array([[r["start_x"], r["start_y"], r["heading"], r["vx"], r["vy"]]
                      for r in rows], np.float32)
    return starts, inits


class Driver(Base):
    name = "serve_http"

    def setup(self) -> None:
        from defensive_model_vae_tpu_torch.serving import build_serve_fn, make_http_server

        t = self.traffic
        self.models = sorted(t["models"])
        self.batch, self.steps = int(t["batch"]), int(t["steps"])
        self.windows = {m: np.load(ROOT / t["models"][m]["fixture"]) for m in self.models}
        self.spans = []          # (model, seconds) of each serve program call
        self._fault = None
        fns = {}
        for m in self.models:
            fn = build_serve_fn(str(ROOT / t["models"][m]["ckpt"]), self.steps,
                                float(t["models"][m]["dt"]), device=self.device)
            fns[m] = self._wrapped(m, fn)
        self.fns = fns
        self.server = make_http_server(fns, self.batch, self.steps, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        for m in self.models:  # warm each program through the endpoint
            self._post(self._request(-1 - self.models.index(m), model=m))
        self.spans.clear()

    def _wrapped(self, model, fn):
        tracer = self.ctx.tracer

        def serve(seed, starts, inits):
            s = time.perf_counter()
            with tracer.span("serve.program"):
                states, controls = fn(seed, starts, inits)
                if self._fault is not None:
                    states, controls = self._fault(states, controls)
                if self.on_card():
                    torch.cuda.synchronize(self.device)
            self.spans.append((model, time.perf_counter() - s))
            return states, controls
        return serve

    def _request(self, i: int, model: str = None) -> dict:
        rng = np.random.default_rng(seeds.derive(self.ctx.seed, "request", i))
        model = model or self.models[int(rng.integers(len(self.models)))]
        picks = rng.integers(len(self.windows[model]), size=self.batch)
        return {"model": model, "seed": seeds.derive(self.ctx.seed, "request seed", i),
                "format": self.traffic["format"],
                "requests": start_rows(self.windows[model], picks)}

    def _post(self, body: dict):
        req = urllib.request.Request(f"{self.base}/serve", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=float(self.traffic["timeout_s"])) as r:
            raw = r.read()
        if body["format"] == "npz":
            with np.load(io.BytesIO(raw)) as z:
                out = {k: z[k] for k in ("invalid", "states", "controls")}
        else:
            out = json.loads(raw)
        if len(out.get("invalid", [])):
            raise RuntimeError(f"rows {list(out['invalid'])} came back non-finite")
        return np.asarray(out["states"], np.float32), np.asarray(out["controls"], np.float32)

    def window(self, seconds: float) -> None:
        tracer = self.ctx.tracer
        first, count = self.traffic["trace_requests"]
        self.done = []   # (index, body, latency s, states, controls)
        self.latencies = []
        t0 = time.perf_counter()
        i = 0
        while i == 0 or tracer.enabled and i < first + count \
                or time.perf_counter() - t0 < seconds:  # a traced run reaches its traced requests
            if i == first:
                tracer.begin()
            body = self._request(i)
            self._attempted += 1
            s = time.perf_counter()
            try:
                with tracer.span("serve.request"):
                    states, controls = self._post(body)
                lat = time.perf_counter() - s
                self.done.append((i, body, lat, states, controls))
            except (urllib.error.URLError, OSError, RuntimeError, ValueError, KeyError) as e:
                self._failed += 1
                lat = float(self.traffic["timeout_s"])
                self.ctx.log(f"request {i} failed: {type(e).__name__}: {e}")
            self.latencies.append(lat)
            if i == first + count - 1:
                tracer.end()
            i += 1
        tracer.end()

    def end_to_end(self) -> dict:
        ms = sorted(1e3 * x for x in self.latencies)
        q = statistics.quantiles(ms, n=100, method="inclusive") if len(ms) > 1 else ms * 99
        return {"serve_p50_ms": q[49], "serve_p90_ms": q[89]}

    def counters(self) -> dict:
        first, count = self.traffic["trace_requests"]
        traced = [d for d in self.done if first <= d[0] < first + count]
        tr = self.config["tracker"]
        return {"requests": len(traced), "batch": self.batch, "steps": self.steps,
                "draws": tr["draws"], "P": tr["prediction_horizon"],
                "M": tr["control_horizon"], "lm_iters": tr["lm_iters"],
                "frontend_s": [lat - span for (_, _, lat, _, _), (_, span)
                               in zip(self.done, self.spans)]}

    def release(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        n = len(self.done)
        k = int(self.traffic["check_requests"])
        pick = np.random.default_rng(seeds.derive(self.ctx.seed, "check")).permutation(n)[:k]
        self.checked = [self.done[j] for j in sorted(pick)]
        self.done = []
        self._params = {}
        self._refs = {}
        if self.on_card():
            torch.cuda.empty_cache()

    # -- correct ------------------------------------------------------------------
    def _reference(self, precision: str):
        """The reference's answers to the checked requests at ``precision``
        (float32 with TF32 off; ``tf32`` the control)."""
        if precision in self._refs:
            return self._refs[precision]
        with tf32({"float32": False, "tf32": True}[precision]):
            out = []
            for _, body, _, _, _ in self.checked:
                m = body["model"]
                if m not in self._params:
                    self._params[m] = ref_serve.load_params(
                        str(ROOT / self.traffic["models"][m]["ckpt"]), self.device)
                starts, inits = rows_arrays(body["requests"])
                s, c = ref_serve.serve(self._params[m], body["seed"], starts, inits,
                                       self.steps, float(self.traffic["models"][m]["dt"]),
                                       self.config)
                out.append((s.cpu().numpy(), c.cpu().numpy()))
        self._refs[precision] = out
        return out

    def program_outputs(self):
        return [(s, c) for _, _, _, s, c in self.checked]

    def control_outputs(self):
        return self._reference(self.config["serve_control_precision"])

    def fault_outputs(self, fault: str):
        """The checked requests served again by the program with a fault
        planted where the answer is produced: ``altered`` (row 0's answer
        replaced by row 1's), ``half_batch`` (the second half of the rows
        left out, the first half's answers in their place) or ``unchanged``
        (every step returns the state it was given)."""
        h = self.batch // 2
        plant = {
            "altered": lambda s, c: (torch.cat([s[1:2], s[1:]]), torch.cat([c[1:2], c[1:]])),
            "half_batch": lambda s, c: (torch.cat([s[:h], s[:h]]), torch.cat([c[:h], c[:h]])),
            "unchanged": lambda s, c: (s[:, :1].expand_as(s).contiguous(), c),
        }[fault]
        self._fault = plant
        try:
            out = []
            for _, body, _, _, _ in self.checked:
                starts, inits = rows_arrays(body["requests"])
                st, co = self.fns[body["model"]](body["seed"], starts, inits)
                out.append((st.cpu().numpy(), co.cpu().numpy()))
        finally:
            self._fault = None
        return out

    def _gaps(self, outputs=None):
        """Per checked request, |program − reference| of the states and of
        the controls (``inf`` where a shape differs or a value is not finite)."""
        outs = self.program_outputs() if outputs is None else outputs
        refs = self._reference(self.config["serve_precision"])
        for got, want in zip(outs, refs):
            pair = []
            for a, b in zip(got, want):
                ok = a.shape == b.shape and np.all(np.isfinite(a))
                pair.append(np.abs(a - b) if ok else np.full(b.shape, np.inf, np.float32))
            yield pair

    def check(self, outputs=None):
        """``state_gap``: the largest gap between a tracked state of the
        program's answer and the reference's, over every column (x, y in m,
        heading in rad, speed in m/s), row and step of the checked requests;
        ``control_mean_gap``: for each row and input (acceleration in m/s²,
        steering in rad), the gap between the returned controls and the
        reference's averaged over the request's steps, the largest over rows,
        inputs and checked requests.  The controls are held by their mean:
        a single step's input can sit at its bound on one side and short of
        it on the other, which the next step erases."""
        gaps = {"state_gap": 0.0, "control_mean_gap": 0.0}
        for s, c in self._gaps(outputs):
            gaps["state_gap"] = max(gaps["state_gap"], float(s.max()))
            gaps["control_mean_gap"] = max(gaps["control_mean_gap"],
                                           float(c.mean(axis=1).max()))
        return [{"name": k, "value": v, "limit": float(self.traffic["limits"][k])}
                for k, v in gaps.items()]

    def detail(self, outputs=None) -> dict:
        """The readings beside the compared numbers: ``control_widest_gap``,
        the largest gap of a single returned control."""
        return {"control_widest_gap": max((float(c.max()) for _, c in self._gaps(outputs)),
                                          default=0.0)}
