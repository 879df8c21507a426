"""The port's SUT layer (``sut/``: write-back; ``metrics/surrogate.py``: TTC,
PET, JERK; their CLI commands) against the JAX package's on the same inputs.

The episodes are the committed windows written by ``scripts/episodes.py``,
and committed traces ``results/GeneratedData/tracked_trajectory_*.npy``
written back into them.  JAX reads and writes them with pandas, the port
with ``data.csv_io``.  Tolerances: none — the write-back's output parses to
JAX's header and values bit for bit, and every metric column equals JAX's
with NaN in the same rows.
"""

import contextlib
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from conftest import REPO_ROOT
from defensive_model_vae_tpu import metrics as jmetrics
from defensive_model_vae_tpu import sut as jsut
from defensive_model_vae_tpu.data import csv_io as jcsv
from defensive_model_vae_tpu.sut import writeback as jwb
from defensive_model_vae_tpu_torch import cli, scenarios
from defensive_model_vae_tpu_torch import metrics as tmetrics
from defensive_model_vae_tpu_torch import sut as tsut
from defensive_model_vae_tpu_torch.data import csv_io as tcsv
from defensive_model_vae_tpu_torch.scripts import episodes
from defensive_model_vae_tpu_torch.sut import driver_models as tdm
from defensive_model_vae_tpu_torch.sut import writeback as twb

KEYS = ("sce1", "sce2", "sce3", "sce4")
TRACES = REPO_ROOT / "results" / "GeneratedData"


def _same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _first_traces(key, n=2):
    return sorted(f for f in os.listdir(TRACES) if f.startswith(f"tracked_trajectory_{key}_"))[:n]


# ---------------------------------------------------------------------------
# names, kinematics, the driver model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "tracked_trajectory_sce1_exp1_3.npy", "tracked_trajectory_sce4_exp12_1.npy",
    "TRACKED_TRAJECTORY_SCE2_exp7_2.npy", "tracked_trajectory_sce10_exp1_2.npy",
    "something_else.npy"])
def test_parse_tracked_npy_name_matches_jax(name):
    try:
        want = jsut.parse_tracked_npy_name(name)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            tsut.parse_tracked_npy_name(name)
        return
    got = tsut.parse_tracked_npy_name(name)
    assert got == want
    assert tsut.expected_csv_name(*got) == jsut.expected_csv_name(*want)


def test_unknown_scenario_raises_not_resolved():
    """'sce10' raises, not resolved to sce1 by the registry's substring
    lookup."""
    with pytest.raises(ValueError, match="sce10"):
        tsut.parse_tracked_npy_name("tracked_trajectory_sce10_exp1_2.npy")
    assert tsut.expected_csv_name("sce1", "1", "3") == "exp_1_control_StaticBlindTown05_3.csv"


def test_ego_kinematics_match_jax():
    t = np.arange(5, dtype=float)
    got = tsut.compute_ego_kinematics(np.zeros(5), 2 * t, t)
    assert np.allclose(got[0], 2 * t) and np.allclose(got[2], 2.0) and np.allclose(got[4], 0)
    rng = np.random.default_rng(4)
    theta, v, tt = rng.normal(size=30), rng.uniform(0, 15, 30), np.cumsum(rng.uniform(1, 2, 30))
    for n in (1, 2, 30):
        for a, b in zip(tsut.compute_ego_kinematics(theta[:n], v[:n], tt[:n]),
                        jsut.compute_ego_kinematics(theta[:n], v[:n], tt[:n])):
            assert _same(a, b)


def test_reg157_brake_matches_jax():
    from defensive_model_vae_tpu.sut import driver_models as jdm

    rng = np.random.default_rng(6)
    for _ in range(200):
        args = (rng.uniform(0, 50), rng.uniform(0, 20), rng.uniform(0, 60), rng.uniform(0, 20))
        assert tdm.reg157_brake(*args) == jdm.reg157_brake(*args)
    assert tdm.reg157_brake(0.0, 20.0, 5.0, 0.0) == -6.0
    assert tdm.reg157_brake(0.0, 5.0, 5.0, 10.0) is None


# ---------------------------------------------------------------------------
# the row clock, the merge, the write-back
# ---------------------------------------------------------------------------

NAN = np.nan
CLOCKS = {
    "clean": [0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
    "interior": [0.0, NAN, NAN, 3.0, NAN, 5.0],
    "leading": [NAN, NAN, 2.0, 3.5, 4.0, 5.0],
    "trailing": [0.0, 1.5, 2.0, NAN, NAN, NAN],
    "all_three": [NAN, 1.0, NAN, 3.25, NAN, NAN],
    "one_valid": [NAN, NAN, 7.0, NAN, NAN, NAN],
    "all_nan": [NAN] * 6,
}


@pytest.mark.parametrize("col", ["frame", "time", None])
@pytest.mark.parametrize("case", sorted(CLOCKS))
def test_row_times_match_pandas(case, col):
    """``_row_times`` against JAX's pandas version (``pd.to_numeric`` and
    ``interpolate(limit_direction="both").bfill().ffill()``), with leading,
    trailing and interior NaNs, over every start row and length."""
    clock = np.asarray(CLOCKS[case] * 2)
    names = ["ego_x"] + ([col] if col else [])
    data = np.column_stack([np.arange(len(clock), dtype=float)] + ([clock] if col else []))
    frame, df = tcsv.Frame(names, data), pd.DataFrame(data, columns=names)
    for start in range(0, len(clock)):
        for L in range(0, len(clock) - start + 1):
            got, want = twb._row_times(frame, start, L), jwb._row_times(df, start, L)
            assert got.shape == want.shape and np.array_equal(got, want, equal_nan=True), \
                (start, L, got, want)


def _toy(n=20):
    cols = {"frame": np.arange(n, dtype=float), "ego_x": np.linspace(0, 10, n),
            "ego_y": np.zeros(n), "ego_vx": np.ones(n), "ego_vy": np.zeros(n),
            "ego_ax": np.zeros(n), "ego_ay": np.zeros(n), "ego_yaw": np.zeros(n),
            "sv1_x": np.linspace(5, -5, n)}
    return tcsv.Frame(list(cols), np.column_stack(list(cols.values()))), pd.DataFrame(cols)


@pytest.mark.parametrize("n_traj", [6, 25])
def test_merge_matches_jax(n_traj):
    """Overwrite from the nearest row; a shorter trajectory truncates the
    tail (6 points), a longer one is cut at the episode's end (25)."""
    frame, df = _toy()
    traj = np.column_stack([np.linspace(5, 8, n_traj), np.ones(n_traj),
                            np.full(n_traj, np.pi / 2), np.linspace(3.0, 4.0, n_traj)])
    start = tsut.find_best_start_row(frame, 5.0, 1.0)
    assert start == jsut.find_best_start_row(df, 5.0, 1.0)
    got = tsut.merge_trajectory_into_csv(frame, traj, start)
    want = jsut.merge_trajectory_into_csv(df, traj, start)
    assert got.columns == list(want.columns)
    assert _same(got.data, want.to_numpy(np.float64))
    assert len(got) == (start + n_traj if n_traj < 20 - start else 20)
    assert np.allclose(got["ego_yaw"][start:], 90.0)
    with pytest.raises(KeyError, match="ego_vx"):
        tsut.merge_trajectory_into_csv(tcsv.Frame(["ego_x", "ego_y"], np.zeros((3, 2))),
                                       traj, 0)
    with pytest.raises(ValueError, match="beyond"):
        tsut.merge_trajectory_into_csv(frame, traj, 20)


def test_frame_assign_and_csv_text(tmp_path):
    frame, _ = _toy(5)
    out = frame.assign(ego_x=np.arange(5.0), TTC=np.array([1.5, NAN, -np.inf, 0.1, 1e-300]))
    assert out.columns == frame.columns + ["TTC"] and _same(out["ego_x"], np.arange(5.0))
    assert _same(frame["ego_x"], np.linspace(0, 10, 5))  # the original is untouched
    path = tmp_path / "f.csv"
    tcsv.write_csv(path, out)
    back = tcsv.read_csv(str(path))
    assert back.columns == out.columns
    assert np.array_equal(back.data, out.data, equal_nan=True)
    jback = jcsv.read_csv(str(path))
    assert np.array_equal(jback.to_numpy(np.float64), out.data, equal_nan=True)
    assert tcsv.csv_text(["a", "b"], np.zeros((0, 2))) == "a,b\n"


@contextlib.contextmanager
def _exact_pandas_reader():
    """pandas' ``read_csv`` with its correctly rounded float parser: its
    default parser rounds some 17-digit fields 1 ulp off (see
    :func:`test_writeback_parses_equal_to_jax`)."""
    read = pd.read_csv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd, "read_csv",
                   lambda *a, **k: read(*a, float_precision="round_trip", **k))
        yield


@pytest.fixture(scope="module")
def written_back(tmp_path_factory):
    """For the first two committed traces of each scenario: an episode of
    that scenario's windows, saved under the name ``expected_csv_name``
    asks for, and the trace written back into it by the port, by JAX, and
    by JAX with pandas reading the episode exactly (``{trace: (port, JAX,
    JAX exact, source episode)}``)."""
    root = tmp_path_factory.mktemp("writeback")
    out = {}
    for key in KEYS:
        sce = scenarios.get(key)
        paths = episodes.write_episodes(np.load(sce.fixture_windows)[:4], key,
                                        str(root / "episodes"))
        for i, name in enumerate(_first_traces(key)):
            src = root / "src" / name / sce.town
            src.mkdir(parents=True)
            csv_name = tsut.expected_csv_name(*tsut.parse_tracked_npy_name(name))
            shutil.copy(paths[i], src / csv_name)
            got = tsut.writeback_npy_to_csv(TRACES / name, src.parent, root / "port" / name)
            want = jsut.writeback_npy_to_csv(TRACES / name, src.parent, root / "jax" / name)
            with _exact_pandas_reader():
                exact = jsut.writeback_npy_to_csv(TRACES / name, src.parent,
                                                  root / "jax_exact" / name)
            out[name] = (got, want, exact, paths[i])
    return out


def test_writeback_parses_equal_to_jax(written_back):
    """The port's ``_def.csv`` parses (by JAX's reader) to the header and
    values of JAX's bit for bit, where pandas reads the source episode
    exactly.  With pandas' default parser JAX's file differs only in cells
    that parser rounds 1 ulp off the exact value of the source field: there
    the port keeps the source's value.  The trace starts at its nearest row."""
    assert len(written_back) == 8
    n_cells = n_pandas_off = 0
    for name, (got, want, exact, src) in written_back.items():
        assert got.name == want.name == exact.name and got.name.endswith("_def.csv")
        g, w, e = (jcsv.read_csv(str(p)) for p in (got, want, exact))
        assert list(g.columns) == list(w.columns) == list(e.columns)
        G, W, E = (f.to_numpy(np.float64) for f in (g, w, e))
        assert np.array_equal(G, E, equal_nan=True)
        S = jcsv.read_csv(str(src)).to_numpy(np.float64)[: len(G)]  # exact
        P = pd.read_csv(src).to_numpy(np.float64)[: len(G)]  # pandas' default
        off = ~(np.isclose(G, W, rtol=0, atol=0) | (np.isnan(G) & np.isnan(W)))
        assert np.array_equal(W[off], P[off]) and np.array_equal(G[off], S[off])
        assert np.all(P[off] != S[off])
        n_cells, n_pandas_off = n_cells + G.size, n_pandas_off + int(off.sum())
        traj = np.load(TRACES / name)
        merged = tcsv.read_csv(str(got))
        start = tsut.find_best_start_row(merged, traj[0, 0], traj[0, 1])
        assert np.isclose(merged["ego_x"][start], traj[0, 0])
    assert 0 < n_pandas_off < n_cells / 100


def test_writeback_refusals(tmp_path):
    name = "tracked_trajectory_sce1_exp11_3.npy"
    with pytest.raises(FileNotFoundError, match="exp_11_control_StaticBlindTown05_3.csv"):
        tsut.writeback_npy_to_csv(TRACES / name, tmp_path, tmp_path / "out")
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "exp_11_control_StaticBlindTown05_3.csv").write_text("x\n1\n")
    with pytest.raises(RuntimeError, match="multiple"):
        tsut.writeback_npy_to_csv(TRACES / name, tmp_path, tmp_path / "out")


# ---------------------------------------------------------------------------
# the surrogate metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["TTC", "PET", "JERK"])
def test_surrogate_metrics_match_jax(written_back, metric):
    """compute_metric on every written-back episode: the same sliced rows and
    the same metric column as JAX's, NaN in the same rows."""
    n_finite = n_unsliced = 0
    for name, (got_path, *_) in written_back.items():
        key = name.split("_")[2]
        try:
            want = jmetrics.compute_metric(str(got_path), key, metric)
        except ValueError as e:  # the episode has no SUT start row
            with pytest.raises(ValueError, match=str(e)):
                tmetrics.compute_metric(str(got_path), key, metric)
            n_unsliced += 1
            continue
        got = tmetrics.compute_metric(str(got_path), key, metric)
        assert got.columns == list(want.columns) and len(got) == len(want)
        assert np.array_equal(got.data, want.to_numpy(np.float64), equal_nan=True)
        n_finite += int(np.isfinite(got[metric]).sum())
    # sce4's written episodes hold sv1's acceleration at 0: no SUT start
    assert n_finite > 0 and n_unsliced == 2


@pytest.mark.parametrize("key", KEYS)
def test_slice_and_metrics_match_jax_on_episodes(tmp_path, key):
    """slice_episode, ttc_1d, pet_rays and jerk on written episodes (with a
    sim_time column for jerk's clock), against JAX's on the same rows."""
    paths = episodes.write_episodes(np.load(scenarios.get(key).fixture_windows)[:3], key,
                                    str(tmp_path))
    for path in paths:
        frame = tcsv.read_csv(path)
        sim_time = 0.05 * np.arange(len(frame)) ** 1.01
        sim_time[3] = sim_time[2]  # a zero step
        for f in (frame, frame.assign(sim_time=sim_time)):
            df = pd.DataFrame(f.data, columns=f.columns)
            if key == "sce4":  # sv1's acceleration is 0 throughout: no start row
                f = f.assign(sv1_ax=np.linspace(0.0, 0.3, len(f)))
                df = pd.DataFrame(f.data, columns=f.columns)
            got, want = tmetrics.slice_episode(f, key), jmetrics.slice_episode(df, key)
            assert _same(got.data, want.to_numpy(np.float64))
            for fn in ("ttc_1d", "pet_rays", "jerk"):
                a = getattr(tmetrics, fn)(got, key)
                b = getattr(jmetrics, fn)(want, key)
                assert np.array_equal(a, b, equal_nan=True), fn
    with pytest.raises(ValueError, match="TTC / PET / JERK"):
        tmetrics.compute_metric(paths[0], key, "THW")


# ---------------------------------------------------------------------------
# the CLI commands against their library calls
# ---------------------------------------------------------------------------

def test_cli_writeback_metrics_dnda(written_back, tmp_path, capsys):
    from defensive_model_vae_tpu_torch import dnda as tdnda

    name = "tracked_trajectory_sce1_exp11_3.npy"
    got_path = written_back[name][0]
    src = got_path.parent.parent.parent / "src" / name
    cli.main(["writeback", "--npy", str(TRACES / name), "--data-root", str(src),
              "--out-dir", str(tmp_path / "wb")])
    out = tmp_path / "wb" / got_path.name
    assert capsys.readouterr().out.strip() == f"saved {out}"
    assert out.read_bytes() == got_path.read_bytes()

    for metric in ("TTC", "PET", "JERK"):
        cli.main(["metrics", "--scenario", "sce1", "--csv", str(out), "--metric", metric])
        rep = json.loads(capsys.readouterr().out)
        vals = tmetrics.compute_metric(str(out), "sce1", metric)[metric]
        finite = vals[np.isfinite(vals)]
        assert rep["metric"] == metric and rep["rows"] == len(vals)
        assert rep["valid"] == len(finite)
        assert rep["mean"] == (float(np.mean(finite)) if len(finite) else None)

    res = tdnda.process_episode(str(out), "sce1", max_frames=5, host=True)
    for extra in (["--device", "cpu"], ["--host"]):
        cli.main(["dnda", "--scenario", "sce1", "--csv", str(out), "--max-frames", "5",
                  "--out-csv", str(tmp_path / "f.csv")] + extra)
        rep = json.loads(capsys.readouterr().out)
        assert rep["frames"] == res.frames and rep["dnda"] == res.dnda
        assert rep["max_dnda"] == (res.max_dnda if res.frames else None)
        lines = (tmp_path / "f.csv").read_text().splitlines()
        assert lines[0] == "frame,dnda" and len(lines) == len(res.frames) + 1


def test_cli_dnda_sweep(written_back, tmp_path, capsys):
    from defensive_model_vae_tpu_torch import dnda as tdnda

    d = tmp_path / "score"
    d.mkdir()
    for i, (name, (got, *_)) in enumerate(sorted(written_back.items())[:4]):
        town = scenarios.get(name.split("_")[2]).town
        shutil.copy(got, d / f"DEF_{town}_{i + 1}.csv")
    want = tdnda.score_directory(d, host=True, processes=1)
    for extra in (["--device", "cpu"], ["--host", "--processes", "1"]):
        cli.main(["dnda-sweep", "--dir", str(d), "--out", str(tmp_path / "s.csv")] + extra)
        rows = json.loads(capsys.readouterr().out)
        assert len(rows) == 4
        for r, w in zip(rows, want):
            assert r == {k: (None if k == "max_dnda" and not np.isfinite(v) else v)
                         for k, v in w.items()}
        assert (tmp_path / "s.csv").read_text().splitlines()[0] == \
            "model,scenario,trial,max_dnda,frames,file_path"
