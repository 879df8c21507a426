"""The port's validation metrics (``metrics/``) against the JAX package's on
the same inputs: the 254 committed ``results/GeneratedData`` traces against
human tracks read from the committed windows written as episodes
(``scripts/episodes.py``), and the synthetic cases of
``tests/test_metrics.py``.

Tolerance: a relative difference of 1e-12 (the same numpy and scipy
operations in the same order).
"""

import numpy as np
import pytest

from defensive_model_vae_tpu import metrics as jm
from defensive_model_vae_tpu.metrics import thw as jthw
from defensive_model_vae_tpu_torch import metrics as tm
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.data import collect_csv_files
from defensive_model_vae_tpu_torch.metrics import spatial as tspatial
from defensive_model_vae_tpu_torch.metrics import thw as tthw
from defensive_model_vae_tpu_torch.pipeline import load_humans, load_tracked
from defensive_model_vae_tpu_torch.scripts import episodes

from conftest import REPO_ROOT

KEYS = ("sce1", "sce2", "sce3", "sce4")
GENERATED = REPO_ROOT / "results" / "GeneratedData"
RTOL = 1e-12


def _close(a, b):
    """Equal to RTOL relative (NaN with NaN; containers element by element)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and np.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{key: (tracked traces, human tracks, episode CSVs)}."""
    root = str(tmp_path_factory.mktemp("episodes"))
    episodes.write_fixture_trees(root)
    out = {}
    for key in KEYS:
        csvs = collect_csv_files(f"{root}/{scenarios.get(key).town}")
        out[key] = (load_tracked(str(GENERATED), key), load_humans(key, csvs), csvs)
    return out


def test_committed_traces_are_the_254():
    assert sum(len(load_tracked(str(GENERATED), k)) for k in KEYS) == 254


@pytest.mark.parametrize("key", KEYS)
def test_distribution_matches_jax(cases, key):
    tracked, humans, _ = cases[key]
    gv, hv = tm.extract_velocities(tracked), tm.human_velocities(humans)
    assert _close(gv, jm.extract_velocities(tracked))
    assert _close(hv, jm.human_velocities(humans))
    assert len(hv) == sum(len(h) for h in humans)
    for bins in (50, 17):
        assert _close(tm.velocity_js_divergence(gv, hv, bins),
                      jm.velocity_js_divergence(gv, hv, bins))
    from defensive_model_vae_tpu.metrics.distribution import _track_velocities as j_tv
    from defensive_model_vae_tpu_torch.metrics.distribution import _track_velocities as t_tv

    for h in humans[:5]:
        assert _close(t_tv(h), j_tv(h))


@pytest.mark.parametrize("key", KEYS)
def test_spatial_matches_jax(cases, key):
    tracked, humans, _ = cases[key]
    for grid in (0.5, 1.0):
        for a, b in ((tracked, humans), (humans, tracked)):
            ca, cb = tm.extract_coordinates(a), tm.extract_coordinates(b)
            assert _close(ca, jm.extract_coordinates(a))
            assert _close(tm.rmse_frequency(ca, cb, key, grid),
                          jm.rmse_frequency(ca, cb, key, grid))
            assert _close(tm.rmse_frequency_trajcount(a, b, key, grid),
                          jm.rmse_frequency_trajcount(a, b, key, grid))
        assert _close(tm.count_trajectories_per_grid(tracked, key, grid),
                      jm.count_trajectories_per_grid(tracked, key, grid))
    for axis in ("x", "y"):
        mt, mj = tm.model_stv_data(tracked, key, axis), jm.model_stv_data(tracked, key, axis)
        ht, hj = tm.human_stv_data(humans, axis), jm.human_stv_data(humans, axis)
        assert _close(mt, mj) and _close(ht, hj)
        ms = tm.build_stv_surface(*mt)
        hs = tm.build_stv_surface(*ht, coord_range=(-200.0, 100.0), time_range=(0.0, 20.0))
        assert _close(ms, jm.build_stv_surface(*mj))
        assert _close(hs, jm.build_stv_surface(*hj, coord_range=(-200.0, 100.0),
                                                 time_range=(0.0, 20.0)))
        for zeros in (True, False):
            assert _close(tm.surface_rmse(ms[2], hs[2], zeros),
                          jm.surface_rmse(ms[2], hs[2], zeros))
    for interval in (0.5, 0.25):
        assert _close(tm.spatiotemporal_plane_rmse(humans, tracked, key, interval),
                      jm.spatiotemporal_plane_rmse(humans, tracked, key, interval))


def test_subsample_draw_never_runs_on_the_committed_traces(cases, monkeypatch):
    """``subsample_points`` draws from an unseeded generator only when its
    evenly spaced indices collide, which needs n ≤ max_points, and such
    tracks are returned whole: with the generator made to raise, every
    committed trace and human track subsamples — many of them longer than
    ``max_points`` — and equals JAX's."""
    def no_draw(*a, **k):
        raise AssertionError("subsample_points drew random indices")

    monkeypatch.setattr(tspatial.np.random, "default_rng", no_draw)
    longer = 0
    for tracked, humans, _ in cases.values():
        for tr in list(tracked) + list(humans):
            got = tm.subsample_points(np.asarray(tr)[:, :2])
            assert len(got) == min(len(tr), 150)
            assert _close(got, jm.subsample_points(np.asarray(tr)[:, :2]))
            longer += len(tr) > 150
    assert longer > 400


def test_thw_matches_jax(cases):
    for key in KEYS:
        _, _, csvs = cases[key]
        sv = tthw.start_velocities(csvs, key)
        assert sv == jthw.start_velocities(csvs, key)
        assert len(sv) == len(csvs) and all(v > 0 for _, v in sv)
        if key == "sce2":  # the reference's Get_THW has no sce2 branch
            with pytest.raises(ValueError, match="no THW distance"):
                tthw.thw_values(sv, key)
            continue
        got = tthw.thw_values(sv, key)
        assert _close(got, jthw.thw_values(sv, key))
    # sce4's distance is 40 m for trial suffix 3, else 30 m; zero speed → NaN
    named = [("a/exp_1_x_3.csv", 10.0), ("a/exp_2_x_1.csv", 10.0), ("a/exp_3_x_2.csv", 0.0)]
    assert _close(tthw.thw_values(named, "sce4"), [4.0, 3.0, np.nan])


# ---------------------------------------------------------------------------
# the synthetic cases of tests/test_metrics.py, held against JAX as well
# ---------------------------------------------------------------------------

def test_js_divergence_bounds():
    rng = np.random.default_rng(0)
    a = rng.normal(10, 1, 5000)
    b = rng.normal(30, 1, 5000)
    assert tm.velocity_js_divergence(a, a) < 1e-6  # identical → 0
    assert tm.velocity_js_divergence(a, b) > 0.98  # disjoint → 1
    for x, y in ((a, a), (a, b), (b, a[:100])):
        assert _close(tm.velocity_js_divergence(x, y), jm.velocity_js_divergence(x, y))


def test_velocity_extraction():
    t = np.arange(5, dtype=float)
    traj = np.column_stack([t, t, t])
    v = tm.human_velocities([traj])
    assert v.shape == (5,) and np.allclose(v, np.sqrt(2))
    # a zero-dt segment repeats the previous speed (3.0, not the 1.0 of
    # the placeholder division) — and the carry crosses tracks
    traj2 = np.array([[0, 0, 0.0], [3, 0, 1.0], [4, 0, 1.0], [5, 0, 2.0]])
    v2 = tm.human_velocities([traj2])
    assert np.isclose(v2[0], 3.0) and np.isclose(v2[1], 3.0)
    zero_first = np.array([[0, 0, 0.0], [1, 0, 0.0], [2, 0, 1.0]])
    both = tm.human_velocities([traj2, zero_first])
    assert both[len(v2)] == v2[-1]  # the shared list: not 0
    assert _close(both, jm.human_velocities([traj2, zero_first]))
    tracked = [np.column_stack([t, t, t, 3 * np.ones(5)])]
    assert np.allclose(tm.extract_velocities(tracked), 3.0)
    assert tm.extract_velocities([]).shape == (0,)


def test_subsample_points():
    xy = np.random.default_rng(0).normal(size=(500, 2))
    s = tm.subsample_points(xy, 150)
    assert s.shape == (150, 2) and np.array_equal(s, jm.subsample_points(xy, 150))
    assert np.allclose(s[0], xy[0]) and np.allclose(s[-1], xy[-1])
    assert tm.subsample_points(xy[:100], 150).shape == (100, 2)


def test_rmse_frequency_synthetic():
    pts = np.random.default_rng(1).uniform([-197, 45], [-190, 75], (200, 2))
    assert tm.rmse_frequency(pts, pts, "sce1") == 0.0
    base = np.tile([[-195.5, 50.5]], (3, 1))
    more = np.tile([[-195.5, 50.5]], (7, 1))
    assert np.isclose(tm.rmse_frequency(more, base, "sce1"), 4.0)  # one cell, diff 4
    assert tm.rmse_frequency(np.zeros((0, 2)), np.zeros((0, 2)), "sce1") == 0.0
    assert _close(tm.rmse_frequency(more, pts, "sce1"), jm.rmse_frequency(more, pts, "sce1"))


def test_rmse_frequency_trajcount_synthetic():
    loop = np.tile([[-195.5, 50.5, 0.0]], (50, 1))
    single = np.array([[-195.5, 50.5, 0.0]])
    assert tm.rmse_frequency_trajcount([loop], [single], "sce1") == 0.0
    assert tm.rmse_frequency_trajcount([loop, loop], [single], "sce1") == \
        jm.rmse_frequency_trajcount([loop, loop], [single], "sce1") == 1.0


def test_stv_surface_and_rmse():
    t = np.linspace(0, 10, 100)
    _, _, surf = tm.build_stv_surface([t * 2], [t], [np.full_like(t, 5.0)])
    assert (surf > 0).any()
    assert _close(surf, jm.build_stv_surface([t * 2], [t], [np.full_like(t, 5.0)])[2])
    r, n = tm.surface_rmse(surf, surf)
    assert r == 0.0 and n == surf.size
    _, n2 = tm.surface_rmse(surf, np.zeros_like(surf), include_zero_velocity=False)
    assert n2 == int((surf != 0).sum())
    with pytest.raises(ValueError, match="shapes differ"):
        tm.surface_rmse(surf, surf[1:])


def test_plane_rmse_synthetic():
    t = np.linspace(0, 5, 60)
    human = [np.column_stack([t, t, t])]
    mt = np.arange(len(t)) * 0.02
    model = [np.column_stack([np.interp(mt, t, t), np.interp(mt, t, t),
                              np.zeros(len(t)), np.ones(len(t))])]
    r, errs = tm.spatiotemporal_plane_rmse(human, model, "sce1")
    assert np.isfinite(r) and len(errs) > 0
    assert _close((r, errs), jm.spatiotemporal_plane_rmse(human, model, "sce1"))
    r_off, _ = tm.spatiotemporal_plane_rmse(
        human, [m + np.array([3.0, 4.0, 0, 0]) for m in model], "sce1")
    assert r_off > r
    r_nan, e_nan = tm.spatiotemporal_plane_rmse([], model, "sce1")
    assert np.isnan(r_nan) and e_nan == []
