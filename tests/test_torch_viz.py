"""The port's ``viz/`` against the JAX package's (tests/test_viz.py's cases)
and the CLI's figure commands, on the CPU.

Each figure is held to JAX's by the arrays it draws, not by its pixels:
every axes' lines (``get_xydata``, 3-D ``get_data_3d``), scatter offsets,
patches (histogram and box heights, polygons), mesh arrays with their
colour limits, limits and titles.  Animations by their frame count and the
artists' data at every grabbed frame.  The two packages run the same
numpy, so the arrays agree to 1e-9.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.animation import PillowWriter

import defensive_model_vae_tpu.viz as jviz
import defensive_model_vae_tpu_torch.viz as tviz
from conftest import REPO_ROOT

ATOL = 1e-9


def _patch_data(p):
    from matplotlib.patches import Rectangle

    if isinstance(p, Rectangle):
        return np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()])
    return np.asarray(p.get_path().vertices)


def _axes_data(ax):
    out = {"title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
           "xlim": np.asarray(ax.get_xlim()), "ylim": np.asarray(ax.get_ylim()),
           "lines": [], "collections": [], "patches": [_patch_data(p) for p in ax.patches],
           "texts": [t.get_text() for t in ax.texts]}
    for line in ax.get_lines():
        out["lines"].append(np.asarray(line.get_data_3d()) if hasattr(line, "get_data_3d")
                            else np.asarray(line.get_xydata()))
    for c in ax.collections:
        arr = c.get_array()
        out["collections"].append({
            "offsets": np.asarray(c.get_offsets()),
            "array": None if arr is None else np.asarray(arr),
            "clim": np.asarray(c.get_clim(), float) if arr is not None else None})
    return out


def _fig_data(fig):
    return [_axes_data(ax) for ax in fig.axes]


def _assert_same(a, b, path="fig"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def figures(monkeypatch):
    """Every figure closed while a call runs, captured (closed at the end)."""
    got, close = [], plt.close
    monkeypatch.setattr(plt, "close", lambda fig=None: got.append(fig))
    yield got
    close("all")


def _drawn(figures, fn, *args, **kwargs):
    """(the call's result, the data of each figure it closed)."""
    start = len(figures)
    out = fn(*args, **kwargs)
    return out, [_fig_data(f) for f in figures[start:]]


def _both(figures, name, *args, module="", **kwargs):
    """JAX's and the port's ``name`` on the same arguments → their figures'
    data, asserted equal; → (JAX's result, the port's result)."""
    jmod = getattr(jviz, module) if module else jviz
    tmod = getattr(tviz, module) if module else tviz
    jout, jfigs = _drawn(figures, getattr(jmod, name), *args, **kwargs)
    tout, tfigs = _drawn(figures, getattr(tmod, name), *args, **kwargs)
    assert jfigs and len(jfigs) == len(tfigs)
    _assert_same(jfigs, tfigs)
    return jout, tout


def _history(n=50):
    e = np.arange(n, dtype=float)
    base = np.exp(-e / 10)
    return {k: base * (i + 1) for i, k in enumerate(["total", "recon", "kld", "start", "time"])}


def test_plot_losses_and_csv_roundtrip(tmp_path, figures):
    _both(figures, "plot_losses", _history(), str(tmp_path / "loss.png"))
    back = tviz.load_loss_csv(str(tmp_path / "loss.csv"))
    for k, v in _history().items():
        np.testing.assert_allclose(back[k], v, err_msg=k)
    # the same CSV either way: JAX reads the port's file and the port JAX's
    tviz.save_loss_csv(_history(), str(tmp_path / "t.csv"))
    jviz.save_loss_csv(_history(), str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    committed = tviz.load_loss_csv(str(REPO_ROOT / "results" / "loss" / "sce1.csv"))
    jcommitted = jviz.load_loss_csv(str(REPO_ROOT / "results" / "loss" / "sce1.csv"))
    assert committed.keys() == jcommitted.keys()
    for k in committed:
        np.testing.assert_array_equal(committed[k], jcommitted[k])


def test_vehicle_rectangle_geometry():
    for args in ((1.0, 2.0, 0.0, 4.0, 2.0), (0, 0, np.pi / 2, 4.0, 2.0), (3, -1, 0.7)):
        np.testing.assert_array_equal(tviz.vehicle_rectangle(*args),
                                      jviz.vehicle_rectangle(*args))
    r90 = tviz.vehicle_rectangle(0, 0, np.pi / 2, 4.0, 2.0)
    assert np.isclose(np.ptp(r90[:, 0]), 2.0) and np.isclose(np.ptp(r90[:, 1]), 4.0)


def test_smooth_curve_matches_jax():
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(0.1, 7.0, 9))
    t[0] = 0.0
    pts = np.column_stack([t, np.cumsum(rng.uniform(0.5, 3.0, 9)),
                           np.cumsum(rng.normal(0, 1.0, 9))])
    for heading in (None, 0.7):
        for n in (None, 100):
            np.testing.assert_array_equal(
                tviz.smooth_curve(pts, start_heading=heading, n=n),
                jviz.smooth_curve(pts, start_heading=heading, n=n))
    sm = tviz.smooth_curve(pts, n=100)
    assert sm.shape == (100, 3) and np.allclose(sm[0], pts[0]) and sm[-1, 0] < pts[-1, 0]


def test_velocity_distribution_plot(tmp_path, figures):
    rng = np.random.default_rng(0)
    _both(figures, "plot_velocity_distribution", rng.normal(10, 2, 500),
          rng.normal(11, 2, 400), str(tmp_path / "v.png"), js_divergence=0.1)
    _both(figures, "plot_velocity_distribution", [], [1.0], str(tmp_path / "e.png"))


def test_spatial_distribution_plot(tmp_path, figures):
    pts = np.random.default_rng(0).uniform([-197, 45], [-190, 75], (300, 2))
    _both(figures, "plot_spatial_distribution", pts, "sce1", str(tmp_path / "s.png"))


def test_spatial_distribution_trajectory_count_mode(tmp_path, figures):
    t = np.linspace(0, 5, 80)
    trajs = [np.column_stack([-195 + 0.02 * t, 45 + 5 * t, t]),
             np.column_stack([-193 + 0.02 * t, 45 + 5 * t, t])]
    _both(figures, "plot_spatial_distribution", scenario="sce1",
          save_path=str(tmp_path / "tc.png"), trajectories=trajs)


def test_tracking_results_plot(tmp_path, figures, windows_sce1):
    """The 6-panel MPC figure from the same tracked run, each package's
    figure over its own PathReference."""
    from defensive_model_vae_tpu.control import PathReference as JPathReference
    from defensive_model_vae_tpu_torch.control import MPCConfig, PathReference, track

    wp = windows_sce1[1][:, [1, 2, 0]].astype(float)
    wp[0, 2] = 0.0
    v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
    init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
    times, states, controls = track(wp, init, MPCConfig(prediction_horizon=10,
                                                        control_horizon=5, dt=0.05),
                                    device="cpu")
    states, controls = states.astype(float), controls.astype(float)
    _, jf = _drawn(figures, jviz.plot_tracking_results, times, states, controls, wp,
                   JPathReference(wp, init), str(tmp_path / "j.png"), axis_flip="y")
    _, tf = _drawn(figures, tviz.plot_tracking_results, times, states, controls, wp,
                   PathReference(wp, init), str(tmp_path / "t.png"), axis_flip="y")
    _assert_same(jf, tf)


def test_static_case_and_histogram(tmp_path, figures):
    t = np.linspace(0, 5, 60)
    human = [np.column_stack([-193 + 0.1 * t, 45 + 5 * t, t])]
    bv = [np.column_stack([-190.0 + 0 * t, 60 + 0.5 * t, t])]
    model = np.column_stack([-193.5 + 0.1 * t, 45 + 5 * t, t])
    _both(figures, "plot_static_case", model, human, bv, "sce1", str(tmp_path / "c.png"))
    vals = np.abs(np.random.default_rng(0).normal(5, 1, 100))
    _both(figures, "plot_histogram", vals, str(tmp_path / "h.png"), "THW", "THW (s)")
    _both(figures, "plot_histogram", vals, str(tmp_path / "h0.png"), "THW", "THW (s)",
          x_max=0)


def test_speed_time_curves_from_frames(tmp_path, figures):
    """The port's SUT episodes are ``Frame`` tables where JAX's are pandas
    frames: the same columns give the same curves."""
    import pandas as pd

    from defensive_model_vae_tpu_torch.data.csv_io import Frame

    rng = np.random.default_rng(4)
    cols = ["sim_time", "ego_vx", "ego_vy"]
    a = np.column_stack([np.arange(40) * 0.05 + 3.0, rng.normal(5, 1, 40),
                         rng.normal(0, 1, 40)])
    b = a[:, 1:]  # no sim_time: the scenario's clock
    _, jf = _drawn(figures, jviz.plot_speed_time_curves,
                   {"A #1": pd.DataFrame(a, columns=cols),
                    "B": pd.DataFrame(b, columns=cols[1:])}, "sce2", str(tmp_path / "j.png"))
    _, tf = _drawn(figures, tviz.plot_speed_time_curves,
                   {"A #1": Frame(cols, a), "B": Frame(cols[1:], b)}, "sce2",
                   str(tmp_path / "t.png"))
    _assert_same(jf, tf)


def test_spatiotemporal_plot(tmp_path, figures):
    t = np.linspace(0, 5, 60)
    humans = [np.column_stack([-193 + 0.1 * t, 45 + 5 * t, t])]
    models = [np.column_stack([-193.4 + 0.1 * t, 45 + 5 * t, np.zeros_like(t),
                               np.full_like(t, 5)])]
    jp, tp = _both(figures, "plot_spatiotemporal", humans, models, "sce1", str(tmp_path))
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p) for p in tp]
    assert len(tp) == 2


def test_generated_vs_training_and_offset_curves(tmp_path, figures, windows_sce1):
    _both(figures, "plot_generated_vs_training", windows_sce1[:3] + 0.5, windows_sce1[:10],
          "sce1", str(tmp_path / "g.png"), module="plots")
    t = np.linspace(0, 5, 60)
    model = np.column_stack([-193.2 + 0.1 * t, 45 + 6 * t, t])
    human = np.column_stack([-193.4 + 0.1 * t, 45 + 5.5 * t, t])
    _both(figures, "plot_velocity_and_lateral_offset", model, human, "sce1",
          str(tmp_path / "vo.png"), module="plots")


def test_space_time_velocity_and_colorbar_range(tmp_path, figures):
    t = np.linspace(0, 10, 80)
    args = ([45 + 5 * t, 45 + 5.5 * t], [t, t], [np.full_like(t, 5.0), np.full_like(t, 6.0)],
            str(tmp_path / "lines.png"), str(tmp_path / "surf.png"))
    kw = dict(axis="y", scenario="sce3", coord_range=np.array([40.0, 110.0]),
              time_range=(0.0, 10.0), vmin=0.0, vmax=8.0)
    js, ts = _both(figures, "plot_space_time_velocity", *args, **kw)
    assert ts.shape == (40, 40)
    np.testing.assert_allclose(ts, js, atol=ATOL)
    with pytest.warns(UserWarning):
        assert tviz.plot_space_time_velocity([], [], [], str(tmp_path / "l2.png"),
                                             str(tmp_path / "s2.png")) is None
    rng = np.random.default_rng(0)
    a = rng.uniform([-197, 45], [-190, 75], (200, 2))
    b = rng.uniform([-197, 45], [-190, 75], (900, 2))
    assert tviz.unified_colorbar_range([a, b], "sce1") == \
        jviz.unified_colorbar_range([a, b], "sce1")
    trajs = [np.column_stack([a, np.zeros(len(a))])]
    assert tviz.unified_colorbar_range(scenario="sce1", trajectory_sets=[trajs]) == \
        jviz.unified_colorbar_range(scenario="sce1", trajectory_sets=[trajs])
    assert tviz.unified_colorbar_range([], "sce1") == (0, 1)


@pytest.fixture
def frames(monkeypatch):
    """The artists' data at every frame a PillowWriter grabs."""
    got = []
    grab = PillowWriter.grab_frame

    def recording(self, **kw):
        got.append(_fig_data(self.fig))
        return grab(self, **kw)

    monkeypatch.setattr(PillowWriter, "grab_frame", recording)
    return got


def _gif_frames(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames


def _both_animated(frames, name, tmp_path, *args, **kwargs):
    jp = getattr(jviz, name)(*args[:-1], str(tmp_path / f"j_{args[-1]}"), **kwargs)
    n = len(frames)
    tp = getattr(tviz, name)(*args[:-1], str(tmp_path / f"t_{args[-1]}"), **kwargs)
    assert n and len(frames) == 2 * n
    _assert_same(frames[:n], frames[n:])
    assert _gif_frames(jp) == _gif_frames(tp)
    del frames[:]
    return tp


def test_animations(tmp_path, frames):
    t = np.linspace(0, 3, 40)
    model = np.column_stack([-193.5 + 0.1 * t, 45 + 8 * t, t])
    human = np.column_stack([-193.0 + 0.1 * t, 45 + 7 * t, t])
    bv = np.column_stack([-190.0 + 0.0 * t, 60 + 0 * t, t])
    _both_animated(frames, "animate_human_vs_model", tmp_path, human, bv, None, model,
                   "sce3", "hm.gif", frame_stride=8)
    wp = np.column_stack([2 * t, 0.5 * t, t])
    states = np.column_stack([2 * t, 0.5 * t, np.full_like(t, 0.24), np.full_like(t, 2)])
    _both_animated(frames, "animate_tracking", tmp_path, wp, states, "sce1", "track.gif",
                   frame_stride=8)
    _both_animated(frames, "animate_tracking", tmp_path, wp, states, "sce1", "full.gif",
                   frame_stride=8, draw_lanes=True, static_bv_xy=np.array([3.0, 2.0]),
                   moving_bv_waypoints=np.array([[0.0, -2.0], [4.0, -2.0], [6.0, -1.0]]))


def test_constant_speed_trajectory():
    from defensive_model_vae_tpu.viz.gif import constant_speed_trajectory as j_cst
    from defensive_model_vae_tpu_torch.viz.gif import constant_speed_trajectory

    wp = np.array([[0.0, 0.0], [6.5, 0.0], [6.5, 5.0]])
    path = constant_speed_trajectory(wp, speed=2.0, dt=0.5)
    np.testing.assert_array_equal(path, j_cst(wp, speed=2.0, dt=0.5))
    assert np.allclose(path[0], [0, 0]) and np.allclose(path[-1], [6.5, 5])


def test_lateral_offset_centers_match_jax():
    from defensive_model_vae_tpu import scenarios as jsc
    from defensive_model_vae_tpu_torch import scenarios as tsc

    for key in ("sce1", "sce2", "sce3", "sce4"):
        t, j = tsc.get(key), jsc.get(key)
        assert t.lateral_offset_center == j.lateral_offset_center
        assert (t.plot_xlim, t.plot_ylim, t.axis_flip, t.bv1_plot_size) == \
            (j.plot_xlim, j.plot_ylim, j.axis_flip, j.bv1_plot_size)


# ---- the CLI's figure commands ---------------------------------------------------------

def test_cli_loss_plot(tmp_path):
    from defensive_model_vae_tpu_torch.cli import main

    hist = {k: np.linspace(10, 0.1, 50) for k in ("total", "recon", "kld", "start", "time")}
    csv = tmp_path / "loss.csv"
    tviz.save_loss_csv(hist, str(csv))
    out = tmp_path / "loss.png"
    main(["loss-plot", "--csv", str(csv), "--out", str(out)])
    assert out.stat().st_size > 1000


@pytest.fixture(scope="module")
def episode_tree(tmp_path_factory):
    from defensive_model_vae_tpu_torch.scripts import episodes

    root = tmp_path_factory.mktemp("episodes")
    return root, episodes.write_fixture_trees(str(root), ["sce1"])["sce1"]


def _trace(path):
    n = 60
    np.save(path, np.column_stack([np.full(n, -194.4), np.linspace(40, 60, n),
                                   np.full(n, np.pi / 2), np.full(n, 10.0)]))


def test_cli_gif_and_case(tmp_path, episode_tree, frames, figures):
    """gif and case from an episode CSV and a tracked trace, drawing what
    JAX's CLI draws (JAX's test needs the CARLA CSVs; the committed windows
    written as episodes stand in)."""
    from defensive_model_vae_tpu.cli import main as jmain
    from defensive_model_vae_tpu_torch.cli import main

    from defensive_model_vae_tpu_torch.data.csv_io import read_csv, write_csv

    _, csvs = episode_tree
    _trace(tmp_path / "trace.npy")
    common = ["--scenario", "sce1", "--trace", str(tmp_path / "trace.npy")]
    # the episode's first 2.4 s (a 20 s episode is some 250 frames a side)
    short = tmp_path / os.path.basename(csvs[0])
    write_csv(short, read_csv(csvs[0]).rows(0, 120))
    jmain(["gif", "--csv", str(short), *common, "--out", str(tmp_path / "j.gif")])
    n = len(frames)
    main(["gif", "--csv", str(short), *common, "--out", str(tmp_path / "t.gif")])
    assert n and len(frames) == 2 * n
    _assert_same(frames[:n], frames[n:])
    assert _gif_frames(tmp_path / "t.gif") == _gif_frames(tmp_path / "j.gif")

    start = len(figures)
    jmain(["case", "--csv", *csvs[:3], *common, "--out", str(tmp_path / "j.png")])
    main(["case", "--csv", *csvs[:3], *common, "--out", str(tmp_path / "t.png")])
    jf, tf = (_fig_data(f) for f in figures[start:])
    _assert_same(jf, tf)
    assert (tmp_path / "t.png").stat().st_size > 1000


def test_cli_speed_plots(tmp_path, capsys):
    from defensive_model_vae_tpu_torch import scenarios
    from defensive_model_vae_tpu_torch.cli import main
    from defensive_model_vae_tpu_torch.data.csv_io import Frame, write_csv

    town = scenarios.get("sce1").town
    rng = np.random.default_rng(2)
    for name in (f"AUTOWARE_{town}_1.csv", f"APOLLO_{town}.csv", f"exp_1_{town}.csv"):
        data = np.column_stack([np.arange(30) * 0.05, rng.normal(5, 1, 30),
                                rng.normal(0, 1, 30)])
        write_csv(tmp_path / name, Frame(["sim_time", "ego_vx", "ego_vy"], data))
    out = tmp_path / "speed.png"
    main(["speed-plots", "--scenario", "sce1", "--dir", str(tmp_path), "--out", str(out)])
    assert "(2 SUT episodes)" in capsys.readouterr().out and out.stat().st_size > 1000
    with pytest.raises(SystemExit, match="no .* episodes"):
        main(["speed-plots", "--scenario", "sce2", "--dir", str(tmp_path), "--out",
              str(out)])


def test_cli_thw_histograms(tmp_path, episode_tree, capsys):
    from defensive_model_vae_tpu_torch.cli import main

    root, _ = episode_tree
    main(["thw", "--scenario", "sce1", "--data-root", str(root), "--out-velocity",
          str(tmp_path / "v.png"), "--out-thw", str(tmp_path / "t.png")])
    report = json.loads(capsys.readouterr().out)
    assert report["start_speeds"] and (tmp_path / "v.png").stat().st_size > 1000
    assert ("thw" in report) == (tmp_path / "t.png").exists()
