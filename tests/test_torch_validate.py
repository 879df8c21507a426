"""The port's validation end of the pipeline — ``pipeline.validate``,
``provenance``, ``save_tracked``/``load_tracked``, the CSV half of
``generate_and_track``, ``run_scenario``, ``utils/`` and the ``dataset``,
``pipeline``, ``validate`` and ``thw`` commands — against the JAX package's
on the same inputs, on the CPU.

Inputs: the committed windows written as episodes (``scripts/episodes.py``),
the committed ``results/GeneratedData`` traces and the committed sce2
checkpoint.  Tolerances: metrics 1e-12 relative (the same numpy and scipy
operations in the same order); traces in the same process bit for bit.
Nothing here tracks with JAX (its CPU compile is the slow part): the port's
sampler and tracker are held against JAX in ``tests/test_torch_pipeline.py``.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu import pipeline as jp
from defensive_model_vae_tpu.utils import reporting as jrep
from defensive_model_vae_tpu_torch import pipeline as tp
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.cli import main as cli_main
from defensive_model_vae_tpu_torch.data import (build_dataset, collect_csv_files,
                                                get_start_conditions)
from defensive_model_vae_tpu_torch.metrics.thw import start_velocities, thw_values
from defensive_model_vae_tpu_torch.scripts import episodes
from defensive_model_vae_tpu_torch.train import load_checkpoint
from defensive_model_vae_tpu_torch.utils import (MetricWriter, StageTimer, band_stats,
                                                 jsonable, trace_to)

KEYS = ("sce1", "sce2", "sce3", "sce4")
GENERATED = str(REPO_ROOT / "results" / "GeneratedData")
SCE2_CKPT = str(REPO_ROOT / "results" / "checkpoints" / "sce2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tracker's tensors are small, and the suite
    runs in several worker processes that would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("episodes"))
    episodes.write_fixture_trees(root)
    return root


@pytest.fixture(scope="module")
def sce2_run(root, tmp_path_factory):
    """``run_scenario`` on sce2 with a stage timer → (report, out_dir, timer)."""
    out = str(tmp_path_factory.mktemp("run"))
    timer = StageTimer("cpu")
    return tp.run_scenario(SCE2_CKPT, "sce2", root, out, seed=0, device="cpu",
                           timer=timer), out, timer


def _csvs(root, key):
    return collect_csv_files(os.path.join(root, scenarios.get(key).town))


def _same_report(a, b):
    """Every metric equal to 1e-12 relative (NaN with NaN); counts equal;
    a provenance block is not a metric."""
    assert set(a) - {"provenance"} == set(b) - {"provenance"}
    for k in set(a) - {"provenance"}:
        if isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            assert (math.isnan(a[k]) and math.isnan(b[k])) or \
                math.isclose(a[k], b[k], rel_tol=1e-12, abs_tol=0.0), (k, a[k], b[k])


@pytest.mark.parametrize("key", KEYS)
def test_validate_matches_jax(root, key):
    """The committed traces against the episodes' human tracks, and the
    axis overridden: the port's report is JAX's."""
    tracked = tp.load_tracked(GENERATED, key)
    humans = tp.load_humans(key, _csvs(root, key))
    assert len(humans) == len(tracked) == len(np.load(scenarios.get(key).fixture_windows))
    got = tp.validate(tracked, humans, key)
    _same_report(got, jp.validate(tracked, humans, key))
    assert all(np.isfinite(v) for v in got.values())
    other = "x" if scenarios.get(key).stv_axis == "y" else "y"
    _same_report(tp.validate(tracked[:7], humans[3:], key, stv_axis=other),
                 jp.validate(tracked[:7], humans[3:], key, stv_axis=other))


def test_validate_empty_input_is_a_nan_report(root):
    tracked = tp.load_tracked(GENERATED, "sce2")
    humans = tp.load_humans("sce2", _csvs(root, "sce2"))
    for t, h in (([], humans), (tracked, []), ([], [])):
        got = tp.validate(t, h, "sce2")
        _same_report(got, jp.validate(t, h, "sce2"))
        assert got["n_tracked"] == len(t) and got["n_human"] == len(h)
        assert all(math.isnan(v) for k, v in got.items() if not k.startswith("n_"))


def test_provenance_matches_jax():
    for key in KEYS:
        for kw in ({}, {"n_csvs": 16, "notes": ["a note"]}):
            assert tp.provenance(key, 3, **kw) == jp.provenance(key, 3, **kw)
    p = tp.provenance("sce4", 0, n_csvs=134)
    assert p["tracker"] == {"prediction_horizon": 30, "control_horizon": 20, "dt": 0.02}
    assert any("n=134" in n for n in p["notes"]) and p["grid_size_m"] == tp.GRID_SIZE_M
    assert tp.METRIC_CAVEATS == jp.METRIC_CAVEATS


def test_load_tracked_takes_the_exact_prefix(tmp_path):
    """sce1 takes neither sce10's traces nor stray files with its key."""
    for name in ("tracked_trajectory_sce1_exp1_1.npy", "tracked_trajectory_sce1_exp2_3.npy",
                 "tracked_trajectory_sce10_exp1_1.npy", "sce1_notes.npy",
                 "tracked_trajectory_sce1_exp3_1.txt"):
        np.save(tmp_path / name, np.full((3, 4), len(name), float)) if name.endswith(".npy") \
            else (tmp_path / name).write_text("x")
    got = tp.load_tracked(str(tmp_path), "sce1")
    want = jp.load_tracked(str(tmp_path), "sce1")
    assert len(got) == len(want) == 2
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_trace_names_collisions_and_malformed_names():
    ok = ["/d/减速/exp_11_control_T_3.csv", "/d/转向/exp_11_control_T_2.csv"]
    assert tp._validated_trace_names("sce1", ok) == jp._validated_trace_names("sce1", ok) == \
        ["tracked_trajectory_sce1_exp11_3.npy", "tracked_trajectory_sce1_exp11_2.npy"]
    clash = ["/d/减速/exp_11_control_T_3.csv", "/d/转向/exp_11_other_T_3.csv"]
    for names, match in ((clash, "collision"), (["/d/a/notes.csv"], "unrecognized")):
        with pytest.raises(ValueError, match=match):
            tp._validated_trace_names("sce1", names)
        with pytest.raises(ValueError, match=match):
            jp._validated_trace_names("sce1", names)


def test_save_tracked_round_trip(tmp_path):
    traces = [np.arange(12.0).reshape(3, 4), np.ones((2, 4), np.float32)]
    names = ["tracked_trajectory_sce2_exp1_1.npy", "tracked_trajectory_sce2_exp2_2.npy"]
    paths = tp.save_tracked(traces, names, str(tmp_path / "g"))
    assert [os.path.basename(p) for p in paths] == names
    back = tp.load_tracked(str(tmp_path / "g"), "sce2")
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(back, traces))


def test_run_scenario_sce2(root, sce2_run):
    """The episodes' starts → the committed checkpoint → one trace a valid
    sample, saved under unique names, each bit for bit
    ``generate_and_track_from_starts`` on the starts and initial states
    ``get_start_conditions`` read; ``validation_sce2.json`` is the report,
    JAX's ``validate`` on the same traces and humans."""
    report, out, timer = sce2_run
    csvs = _csvs(root, "sce2")
    params, cfg, _ = load_checkpoint(SCE2_CKPT, "cpu")
    starts, inits = tp.csv_starts("sce2", csvs)
    conds = [get_start_conditions(c, "sce2") for c in csvs]
    assert np.array_equal(starts, np.array([[c.x, c.y] for c in conds], np.float32))
    assert np.array_equal(inits, np.stack([c.as_state() for c in conds]))
    ref, idx = tp.generate_and_track_from_starts(params, cfg, starts, inits, seed=0,
                                                 mpc_cfg=tp.default_mpc_cfg(
                                                     scenarios.get("sce2")))
    names = [tp._csv_trace_name("sce2", csvs[b]) for b in idx]
    gen_dir = os.path.join(out, "GeneratedData")
    assert sorted(os.listdir(gen_dir)) == sorted(names) and len(set(names)) == len(names)
    for name, tr in zip(names, ref):
        got = np.load(os.path.join(gen_dir, name))
        assert got.dtype == tr.dtype and got.tobytes() == tr.tobytes()
        assert np.all(np.isfinite(got))
    humans = tp.load_humans("sce2", csvs)
    _same_report(report, jp.validate(ref, humans, "sce2"))
    assert report["n_tracked"] == len(idx) == 16 and report["n_human"] == 16
    with open(os.path.join(out, "validation_sce2.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(jsonable(report)))
    assert saved["provenance"] == jsonable(tp.provenance("sce2", 0, n_csvs=16))
    assert list(timer.report()) == ["sce2_conditions", "sce2_generate", "sce2_track"]


def test_run_scenario_without_human_tracks_writes_null(tmp_path):
    """Episodes whose start mask never hits: every start falls back to the
    scenario's (−155, −5, −π/2) at rest, no human track is extracted, and
    the NaN report's metrics are ``null`` in the JSON.  A stale trace of
    the scenario is cleared; another scenario's stays."""
    rows = episodes.episode_rows(np.load(scenarios.get("sce2").fixture_windows)[0], "sce2")
    folder = tmp_path / "data" / scenarios.get("sce2").town / scenarios.ACTIONS[0]
    folder.mkdir(parents=True)
    for n in (1, 2):
        (folder / f"exp_{n}_control_x_{n}.csv").write_text(
            ",".join(episodes.COLUMNS) + "\n" + "\n".join(
                ",".join(map(repr, r)) for r in rows[: episodes.LEAD_IN].tolist()))
    gen = tmp_path / "out" / "GeneratedData"
    gen.mkdir(parents=True)
    np.save(gen / "tracked_trajectory_sce2_exp9_9.npy", np.zeros((2, 4)))
    np.save(gen / "tracked_trajectory_sce1_exp9_9.npy", np.zeros((2, 4)))
    report = tp.run_scenario(SCE2_CKPT, "sce2", str(tmp_path / "data"), str(tmp_path / "out"),
                             device="cpu")
    assert report["n_human"] == 0 and math.isnan(report["velocity_js_divergence"])
    saved = json.loads((tmp_path / "out" / "validation_sce2.json").read_text())
    assert all(saved[k] is None for k in report if k not in ("n_tracked", "n_human",
                                                             "provenance"))
    left = sorted(os.listdir(gen))
    assert "tracked_trajectory_sce2_exp9_9.npy" not in left
    assert "tracked_trajectory_sce1_exp9_9.npy" in left
    assert report["n_tracked"] == len(left) - 1


def test_generate_and_track_multi_reads_the_csv_starts(root):
    """The multi-seed path on the CSVs' starts: each seed's names are its
    valid rows' and its traces the from-starts path's (one batch)."""
    csvs = _csvs(root, "sce2")[:3]
    params, cfg, _ = load_checkpoint(SCE2_CKPT, "cpu")
    mpc = tp.default_mpc_cfg(scenarios.get("sce2"))
    starts, inits = tp.csv_starts("sce2", csvs)
    got = tp.generate_and_track_multi(params, cfg, "sce2", csvs, [0, 1], mpc)
    want = tp.generate_and_track_multi_from_starts(params, cfg, starts, inits, [0, 1], mpc)
    for s in (0, 1):
        traces, names = got[s]
        assert names == [tp._csv_trace_name("sce2", csvs[b]) for b in want[s][1]]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(traces, want[s][0]))
    with pytest.raises(ValueError, match="aliases"):
        tp.generate_and_track_multi(params, cfg, "sce2", csvs, [0, 1000], mpc)


def test_cli_pipeline_validate_dataset_and_thw(root, sce2_run, tmp_path, capsys):
    """The four commands on the CPU against the library calls."""
    report, out, _ = sce2_run
    cli_main(["pipeline", "--ckpt", SCE2_CKPT, "--scenario", "sce2", "--data-root", root,
              "--out", str(tmp_path / "p"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(jsonable(report)))
    for f in os.listdir(os.path.join(out, "GeneratedData")):
        assert np.load(tmp_path / "p" / "GeneratedData" / f).tobytes() == \
            np.load(os.path.join(out, "GeneratedData", f)).tobytes()

    cli_main(["validate", "--scenario", "sce2", "--tracked-dir",
              os.path.join(out, "GeneratedData"), "--data-root", root])
    printed = json.loads(capsys.readouterr().out)
    assert printed == {k: v for k, v in json.loads(json.dumps(jsonable(report))).items()
                       if k != "provenance"}

    for extra in ([], ["--point-mode", "extend_mid"], ["--variant", "artifact"]):
        cli_main(["dataset", "--scenario", "sce1", "--data-root", root, "--out",
                  str(tmp_path / "w.npy"), *extra])
        kw = {"point_mode": extra[1]} if extra[:1] == ["--point-mode"] else \
            {"dataset_variant": extra[1]} if extra else {}
        assert np.load(tmp_path / "w.npy").tobytes() == \
            build_dataset(root, "sce1", **kw).tobytes()
    assert "saved (38, 10, 3) windows" in capsys.readouterr().out

    for key in ("sce2", "sce4"):
        cli_main(["thw", "--scenario", key, "--data-root", root])
        printed = json.loads(capsys.readouterr().out)
        sv = start_velocities(_csvs(root, key), key)
        assert printed["start_speeds"] == {n: round(v, 3) for n, v in sv}
        if key == "sce2":
            assert "thw" not in printed
        else:
            assert printed["thw"] == [round(float(t), 3) for t in thw_values(sv, key)]
    # the histogram PNGs (viz/, on the host)
    cli_main(["thw", "--scenario", "sce4", "--data-root", root, "--out-thw",
              str(tmp_path / "t.png"), "--out-velocity", str(tmp_path / "v.png")])
    assert (tmp_path / "t.png").stat().st_size > 1000
    assert (tmp_path / "v.png").stat().st_size > 1000


def test_utils_match_jax(tmp_path):
    """jsonable, band_stats and MetricWriter as JAX's; StageTimer's report;
    trace_to writes a torch.profiler trace."""
    obj = {"a": float("nan"), "b": np.float32(np.inf), "c": [np.int64(3), np.bool_(True)],
           "d": np.array([1.5, np.nan]), "e": (np.float64(2.0), "s")}
    assert jsonable(obj) == jrep.jsonable(obj)
    for vals in ([], [1.0], [1.0, 2.0, 4.5]):
        got, want = band_stats(vals), jrep.band_stats(vals)
        assert json.dumps(jsonable(got)) == json.dumps(jrep.jsonable(want))
    w = MetricWriter(str(tmp_path / "m" / "metrics.jsonl"))
    w.write("js", float("nan"), scenario="sce2")
    w.write_dict({"rmse": np.float32(1.5)}, seed=3)
    assert w.read() == [{"metric": "js", "value": None, "scenario": "sce2"},
                        {"metric": "rmse", "value": 1.5, "seed": 3}]
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            pass
    with timer.stage("b"):
        pass
    rep = timer.report()
    assert list(rep) == ["a", "b"] and rep["a"]["calls"] == 2 and rep["b"]["seconds"] >= 0
    timer.dump(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == rep
    with trace_to(str(tmp_path / "trace")):
        torch.ones(4).add(1)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with trace_to(None):
        pass
