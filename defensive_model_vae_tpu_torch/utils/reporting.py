"""Machine-readable metric reporting.

Port of ``defensive_model_vae_tpu/utils/reporting.py``.

The reference publishes numbers by printing to stdout and hand-curating a
text file (``results/ModelValidation/JS_divergence.txt``).  The rebuild
writes structured JSON-lines records instead (SURVEY §5 directive).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


class MetricWriter:
    """Append-only JSONL metric log."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, name: str, value: Any, **tags):
        record: Dict[str, Any] = {"metric": name, "value": value, **tags}
        with open(self.path, "a") as f:
            # jsonable: non-finite floats become null — bare NaN tokens are
            # not valid JSON and break non-Python JSONL consumers
            f.write(json.dumps(jsonable(record)) + "\n")

    def write_dict(self, metrics: Dict[str, Any], **tags):
        for k, v in metrics.items():
            self.write(k, v, **tags)

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def band_stats(values) -> Dict[str, Any]:
    """Mean / sample-std / 95% t-CI summary of a metric band.

    This is the statistic behind every scoreboard cell in PARITY.md
    (``results/validation_multiseed.json``): sample std (ddof=1), and a
    two-sided Student-t 95% interval ``mean ± t_{.975,n-1}·std/√n``.
    Returns ``std=0`` and no CI keys for ``n < 2``.
    """
    import numpy as np

    vals = np.asarray(list(values), dtype=float)
    n = len(vals)
    out: Dict[str, Any] = {
        "mean": float(vals.mean()) if n else float("nan"),
        "std": float(vals.std(ddof=1)) if n >= 2 else 0.0,
        "values": [float(v) for v in vals],
    }
    if n >= 2:
        from scipy.stats import t as student_t

        half = float(student_t.ppf(0.975, n - 1) * out["std"] / np.sqrt(n))
        out["ci95"] = [out["mean"] - half, out["mean"] + half]
        out["ci95_halfwidth"] = half
    return out


def jsonable(obj: Any) -> Any:
    """Recursively convert non-finite floats to ``None``.

    Bare ``NaN``/``Infinity`` tokens are not valid JSON (RFC 8259) and
    break non-Python consumers; every artifact writer in the repo routes
    its payload through this before ``json.dump``.
    """
    if isinstance(obj, (float, np.floating)):
        # np.floating too: a raw np.float32 metric is NOT a Python float
        # (np.float64 subclasses float; float32 does not) — it would sail
        # past a float-only check and crash json.dumps instead of
        # becoming null
        f = float(obj)
        return None if (f != f or abs(f) == float("inf")) else f
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return jsonable(obj.tolist())
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj
