"""A run's shape, its refusals, and that ``correct`` comes out false where
the timed path is broken underneath or the control takes its place.

The runs here skip the harness's look for a card (``run.run_cell`` on the
CPU, the port's plain versions) at sizes a test can hold; the limits are
the cells' own.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import calibrate, manifest as mf, run

SMALL = {
    "cvae-scale-bf16": {"rows": 256, "epochs": 4, "tile": 64},
    "cvae-serve-b16": {"steps": 12, "check_requests": 2},
    "conv-long-32k": {"rows": 48, "epochs": 4},
}
SEED = 2**31 + 12345

DRY_RUNS = """
import json, sys
from port_bench import manifest as mf, run
SMALL = json.loads(sys.argv[1])
if __name__ == "__main__":
    m = mf.load()
    for cell, small in SMALL.items():
        for trace in (False, True):
            result, _ = run.run_cell(m, cell, %d, 0.5, trace, "cpu", small)
            print(json.dumps({"cell": cell, "trace": trace, "result": result}))
    print(json.dumps({"forbidden": run.forbidden_modules(),
                      "port": "defensive_model_vae_tpu_torch" in sys.modules}))
""" % SEED


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """Every cell, untraced and traced, in a fresh interpreter (so that
    nothing the test process loaded can hide a JAX import)."""
    script = tmp_path_factory.mktemp("dry") / "dry_runs.py"
    script.write_text(DRY_RUNS)
    out = subprocess.run([sys.executable, str(script), json.dumps(SMALL)], cwd=mf.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(mf.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def test_no_jax_after_every_driver(dry_runs):
    last = dry_runs[-1]
    assert last["forbidden"] == [] and last["port"] is True
    assert run.forbidden_modules.__doc__ and "jax" in run.FORBIDDEN
    # the port's name begins with the JAX package's: compared whole, it is not it
    assert "defensive_model_vae_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_result_line_shape(dry_runs):
    m = mf.load()
    for line in dry_runs[:-1]:
        r, cell = line["result"], line["cell"]
        keys = list(r)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks" and r["correct"] is True and r["failed"] == 0
        assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert r["device"]["count"] == next(w["chips"] for w in m["workloads"]
                                            if w["name"] == cell)
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}
        if line["trace"]:
            assert {"busy_s", "window_s"} <= set(r["device"])
            assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
            assert all(len(v) <= 10 for v in r["breakdown"].values())
            allowed = {p["name"] for p in mf.per_layer_for(m, cell)}
            assert set(r["metrics"]) <= allowed
        else:
            assert set(r["metrics"]) == {e["name"] for e in mf.end_to_end_for(m, cell)}
            for v in r["metrics"].values():
                assert v["value"] > 0


def test_refuses_without_cards(tmp_path):
    """No card: a non-zero exit and no result, in the checkout and in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(mf.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (mf.ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                              "cvae-scale-bf16", "--seed", "1", "--seconds", "1"],
                             cwd=cwd, capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert out.returncode != 0 and out.stdout.strip() == ""


def _adam_unchanged(params, grads, m, v, *rest):
    return list(params), m, v


def _train_conv_unchanged(monkeypatch):
    monkeypatch.setattr(_train(), "_adam", lambda leaves, grads, m, v, count, lr:
                        ([p.detach() for p in leaves], m, v))


def _half_batch(module, name):
    """The entry ``module.name`` trained on the first half of its windows."""
    def plant(monkeypatch):
        original = getattr(module(), name)
        monkeypatch.setattr(module(), name,
                            lambda windows, *a, **k: original(windows[: len(windows) // 2], *a, **k))
    return plant


def _fused_scale():
    from defensive_model_vae_tpu_torch.ops import fused_scale

    return fused_scale


def _train():
    return importlib.import_module("defensive_model_vae_tpu_torch.train.train")


def _serve_wrap(alter):
    def plant(monkeypatch):
        from defensive_model_vae_tpu_torch.control import device_reference as dr

        make = dr.make_serve_fn

        def broken(*a, **k):
            fn = make(*a, **k)
            return lambda *aa, **kk: alter(*fn(*aa, **kk))
        monkeypatch.setattr(dr, "make_serve_fn", broken)
    return plant


def _shifted_row(states):
    """One answer altered where it is produced: row 0's first column (x,
    or the acceleration) moved by 1."""
    out = states.clone()
    out[0, :, 0] += 1.0
    return out


def _first_half_twice(states):
    """Half of the batch left out: the first half's answers in its place."""
    import torch

    h = states.shape[0] // 2
    return torch.cat([states[:h], states[:h]])


def _serve_step_unchanged(monkeypatch):
    from defensive_model_vae_tpu_torch.control import mpc

    step = mpc._step

    def unchanged(prob, buf):
        state = buf.state.clone()
        step(prob, buf)
        buf.state.copy_(state)
    monkeypatch.setattr(mpc, "_step", unchanged)


FAULTS = {
    ("cvae-scale-bf16", "unchanged"):
        lambda mp: mp.setattr(_fused_scale(), "_adam_step", _adam_unchanged),
    ("cvae-scale-bf16", "half_batch"): _half_batch(_fused_scale, "fused_train_scale"),
    ("conv-long-32k", "unchanged"): _train_conv_unchanged,
    ("conv-long-32k", "half_batch"): _half_batch(_train, "train_conv"),
    ("cvae-serve-b16", "altered"): _serve_wrap(lambda s, c: (_shifted_row(s), c)),
    ("cvae-serve-b16", "half_batch"): _serve_wrap(lambda s, c: (_first_half_twice(s), c)),
    ("cvae-serve-b16", "altered_control"): _serve_wrap(lambda s, c: (s, _shifted_row(c))),
    ("cvae-serve-b16", "unchanged"): _serve_step_unchanged,
}


@pytest.mark.parametrize("cell, fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    result, checks = run.run_cell(mf.load(), cell, SEED, 0.2, False, "cpu", SMALL[cell])
    assert result["correct"] is False, checks


def test_the_json_answer_is_held_as_the_npz_one():
    """The serve driver reads the endpoint's JSON answer too, so a cell of
    JSON traffic needs only its traffic file."""
    small = dict(SMALL["cvae-serve-b16"], format="json")
    result, checks = run.run_cell(mf.load(), "cvae-serve-b16", SEED, 0.2, False, "cpu", small)
    assert result["correct"] is True and {c["name"] for c in checks} == {"state_gap",
                                                                         "control_mean_gap"}


def test_the_fp8_control_is_not_correct():
    """The reference one precision below the configuration's (fp8 products
    for bf16) in the program's place fails a limit."""
    cell = "cvae-scale-bf16"
    out = calibrate.readings(mf.load(), cell, SEED, 0.0, [], "cpu", SMALL[cell])
    limits = mf.cell(mf.load(), cell)[2]["limits"]
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32, the control of the float32 cells, exists only on the card")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["conv-long-32k", "cvae-serve-b16"])
def test_the_tf32_control_is_not_correct(cell, card):
    """At the cell's own size, one unit of work (TF32's error grows with
    the tracker's steps and the batch, so small sizes would not show it)."""
    m = mf.load()
    out = calibrate.readings(m, cell, SEED, 0.0, [], card)
    limits = mf.cell(m, cell)[2]["limits"]
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out
