"""``pipeline.reproduce_scoreboard`` and ``cli.py reproduce`` of the port
against the JAX package's, on the CPU.

The wiring test runs JAX's own scenario (``tests/test_pipeline.py:329``)
against both packages with the same fake ``run_scenario``, and holds the
returned dicts and ``scoreboard.json`` equal.  The end-to-end tests run the
port on an sce2 episode tree written from the committed windows
(``scripts/episodes.py``) with a checkpoint trained by JAX's scan trainer
from ``init_params(PRNGKey(0))`` and carried across by ``params_from_numpy``:
a rerun at the same seed passes the check, the report has JAX's keys, and
``validate`` on the port's traces is JAX's to 1e-12 relative (as in
tests/test_torch_validate.py).  The torch generator is not ``jax.random``,
so the sampled values themselves are not compared.  On a written tree the
scoreboard describes that data, not the human logs.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from defensive_model_vae_tpu import pipeline as jp
from defensive_model_vae_tpu import scenarios as jscenarios
from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
from defensive_model_vae_tpu.train import train as jtrain
from defensive_model_vae_tpu_torch import pipeline as tp
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.cli import main as cli_main
from defensive_model_vae_tpu_torch.data import collect_csv_files
from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.scripts import episodes
from defensive_model_vae_tpu_torch.train.checkpoint import params_from_numpy, save_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tracker's tensors are small, and the suite
    runs in several worker processes that would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the wiring, against both packages
# ---------------------------------------------------------------------------

def _wiring(pipeline, reg, tmp, monkeypatch):
    """JAX's wiring scenario on one package → the calls it made, and what it
    returned and wrote as JSON text (NaN spelled out) for comparison."""
    seen = []
    (tmp / "validation_sce2.json").write_text(json.dumps({"provenance": {"seed": 42}}))
    calls = []

    def fake_run_scenario(ckpt, key, data_root, out, seed=0, device=None):
        calls.append((ckpt, key, seed))
        pb = reg.get(key).published_best
        return {m: v * (0.5 if key == "sce1" else 2.0) for m, v in pb.items()}

    monkeypatch.setattr(pipeline, "run_scenario", fake_run_scenario)

    def run(**kw):
        out = pipeline.reproduce_scoreboard("ckpts", "data", str(tmp), **kw)
        seen.append((out, json.loads((tmp / "scoreboard.json").read_text())))
        return out

    out = run(scenario_keys=["sce1", "sce2"])
    assert [(c[1], c[2]) for c in calls] == [("sce1", 0), ("sce2", 42)]
    assert calls[0][0] == os.path.join("ckpts", "sce1")
    board = seen[-1][1]
    assert all(cell["beats"] for cell in board["sce1"].values())
    assert not any(cell["beats"] for cell in board["sce2"].values())
    assert set(out) == {"sce1", "sce2"}

    # a subset rerun with a seed override refreshes only its scenario
    run(scenario_keys=["sce2"], seeds={"sce2": 7})
    assert calls[-1][2] == 7
    assert set(seen[-1][1]) == {"sce1", "sce2"} and seen[-1][1]["sce1"] == board["sce1"]

    # check: a matching artifact passes, a moved metric is caught
    expected = {m: v * 2.0 for m, v in reg.get("sce2").published_best.items()}
    art = dict(expected, provenance={"seed": 7})
    (tmp / "validation_sce2.json").write_text(json.dumps(art))
    assert run(scenario_keys=["sce2"], seeds={"sce2": 7},
               check=True)["sce2"]["check_failures"] == {}
    m0 = next(iter(expected))
    art[m0] = expected[m0] + 0.5
    (tmp / "validation_sce2.json").write_text(json.dumps(art))
    assert list(run(scenario_keys=["sce2"], seeds={"sce2": 7},
                    check=True)["sce2"]["check_failures"]) == [m0]

    # a missing baseline is a failure, never a vacuous pass
    (tmp / "validation_sce2.json").unlink()
    assert "__artifact__" in run(scenario_keys=["sce2"], seeds={"sce2": 7},
                                 check=True)["sce2"]["check_failures"]

    # a NaN regenerated metric is caught
    nan_report = dict(expected)
    (tmp / "validation_sce2.json").write_text(json.dumps(dict(nan_report,
                                                              provenance={"seed": 7})))
    m1 = next(iter(nan_report))

    def nan_run_scenario(ckpt, key, data_root, out, seed=0, device=None):
        return dict(nan_report, **{m1: float("nan")})

    monkeypatch.setattr(pipeline, "run_scenario", nan_run_scenario)
    assert list(run(scenario_keys=["sce2"], seeds={"sce2": 7},
                    check=True)["sce2"]["check_failures"]) == [m1]

    # a committed null is a metric: null → finite is drift, null → NaN is not
    art7 = dict(nan_report, provenance={"seed": 7})
    art7[m1] = None
    (tmp / "validation_sce2.json").write_text(json.dumps(art7))
    monkeypatch.setattr(pipeline, "run_scenario", fake_run_scenario)
    assert list(run(scenario_keys=["sce2"], seeds={"sce2": 7},
                    check=True)["sce2"]["check_failures"]) == [m1]
    monkeypatch.setattr(pipeline, "run_scenario", nan_run_scenario)
    assert run(scenario_keys=["sce2"], seeds={"sce2": 7},
               check=True)["sce2"]["check_failures"] == {}

    # an unreadable artifact: the seed falls back to 0, the check fails
    (tmp / "validation_sce2.json").write_text("{not json")
    out9 = run(scenario_keys=["sce2"], check=True)
    assert "__artifact__" in out9["sce2"]["check_failures"]
    # an error names the artifact's path, which differs by package
    return [c[1:] for c in calls], json.dumps(seen, sort_keys=True).replace(str(tmp), "T")


def test_reproduce_scoreboard_wiring_equals_jax(tmp_path, monkeypatch, capsys):
    """Seed recovery, the subset rerun, the seed override, the check passing,
    and a moved metric, a NaN, a committed null and a missing or unreadable
    artifact caught: the port's returned dicts and scoreboard.json are
    JAX's, step for step, and so is the warning on stderr."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _wiring(jp, jscenarios, tmp_path / "jax", monkeypatch)
    jax_err = capsys.readouterr().err
    got = _wiring(tp, scenarios, tmp_path / "torch", monkeypatch)
    torch_err = capsys.readouterr().err
    assert got == want
    assert "WARNING: could not read recorded seed" in torch_err
    assert torch_err.replace(str(tmp_path / "torch"), "T") == \
        jax_err.replace(str(tmp_path / "jax"), "T")


# ---------------------------------------------------------------------------
# end to end on the CPU: a written sce2 tree, a checkpoint from JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("episodes")
    episodes.write_fixture_trees(str(root), ["sce2"])
    return str(root)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """sce2's checkpoint: JAX's scan trainer from ``init_params(PRNGKey(0))``
    (300 epochs, so that the samples are drivable), carried across."""
    w = np.load(scenarios.get("sce2").fixture_windows)
    params, hist = jtrain(w, train_cfg=JTrainConfig(epochs=300, seed=0))
    flat = jax.tree_util.tree_map(np.asarray, params)
    root = tmp_path_factory.mktemp("ckpts")
    save_checkpoint(str(root / "sce2"), params_from_numpy(flat, "cpu"), CVAEConfig(), "sce2",
                    {k: np.asarray(v) for k, v in hist.items()})
    return str(root)


def _same_report(a, b):
    """Every metric equal to 1e-12 relative (NaN with NaN); counts equal."""
    assert set(a) - {"provenance"} == set(b) - {"provenance"}
    for k in set(a) - {"provenance"}:
        if isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            assert (math.isnan(a[k]) and math.isnan(b[k])) or \
                math.isclose(a[k], b[k], rel_tol=1e-12, abs_tol=0.0), (k, a[k], b[k])


def test_reproduce_then_check_on_the_cpu(tree, ckpt_root, tmp_path):
    """reproduce_scoreboard on the CPU, then check=True at the same seed:
    no failure; the report's keys are JAX's run_scenario's on the same tree
    and checkpoint; validate on the port's traces is JAX's."""
    out = tmp_path / "out"
    out.mkdir()
    first = tp.reproduce_scoreboard(ckpt_root, tree, str(out), scenario_keys=["sce2"],
                                    seeds={"sce2": 3}, device="cpu")
    report = first["sce2"]["report"]
    assert report["n_tracked"] > 0 and report["n_human"] == 16
    assert all(np.isfinite(v) for k, v in report.items() if k != "provenance")
    assert report["provenance"]["seed"] == 3
    assert set(first["sce2"]["board"]) == set(scenarios.get("sce2").published_best)
    again = tp.reproduce_scoreboard(ckpt_root, tree, str(out), scenario_keys=["sce2"],
                                    check=True, device="cpu")
    assert again["sce2"]["check_failures"] == {}
    assert again["sce2"]["report"]["provenance"]["seed"] == 3  # recovered from the artifact

    jreport = jp.run_scenario(os.path.join(ckpt_root, "sce2"), "sce2", tree,
                              str(tmp_path / "jax"), seed=3)
    assert set(jreport) == set(report)
    assert set(jreport["provenance"]) == set(report["provenance"])
    traces = tp.load_tracked(str(out / "GeneratedData"), "sce2")
    humans = tp.load_humans("sce2", collect_csv_files(os.path.join(
        tree, scenarios.get("sce2").town)))
    assert len(traces) == report["n_tracked"]
    _same_report(tp.validate(traces, humans, "sce2"), jp.validate(traces, humans, "sce2"))


def test_cli_reproduce_table_check_and_missing_tree(tree, ckpt_root, tmp_path, capsys):
    """``cli.py reproduce`` with ``--out`` in a temporary directory: JAX's
    table, CHECK OK on a rerun, exit 1 with the failures as strict JSON
    when a committed metric moved, and an error naming a missing tree."""
    out = str(tmp_path / "out")
    base = ["reproduce", "--ckpt-root", ckpt_root, "--data-root", tree, "--out", out,
            "--scenarios", "sce2", "--device", "cpu"]
    cli_main(base + ["--seeds", "sce2=1"])
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["scenario", "metric", "ours", "published", "beats"]
    assert len(table) == 1 + len(scenarios.get("sce2").published_best)
    assert all(row.split()[0] == "sce2" and row.split()[-1] in ("YES", "no")
               for row in table[1:])

    cli_main(base + ["--check"])
    assert "CHECK OK" in capsys.readouterr().out

    path = os.path.join(out, "validation_sce2.json")
    with open(path) as f:
        art = json.load(f)
    art["surface_rmse_no_zeros"] += 1e-3
    art["rmse_frequency_points"] = None  # committed null, finite now
    with open(path, "w") as f:
        json.dump(art, f)
    with pytest.raises(SystemExit) as e:
        cli_main(base + ["--check"])
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "CHECK FAILED" in text
    failures = json.loads(text[text.index("{"):], parse_constant=pytest.fail)
    assert set(failures["sce2"]) == {"surface_rmse_no_zeros", "rmse_frequency_points"}

    with pytest.raises(SystemExit, match="no episode tree for sce1 at"):
        cli_main(["reproduce", "--data-root", tree, "--out", out, "--scenarios", "sce1",
                  "--device", "cpu"])
