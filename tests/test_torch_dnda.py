"""The port's DNDA (``dnda/``) against the JAX package's on the same inputs.

Every input is made with numpy from a seed, or is a committed trace written
back into an episode of ``scripts/episodes.py``.  Tolerances: the spline,
Frenet, path-cluster, prediction, SAT and polygon code is the same host
numpy and the same native source, so it is held bit for bit; the torch
sweep (``device="cpu"``) is held index-identical to JAX's
``sweep_frames(device=True)`` and to the numpy oracle in both SAT dtypes;
DA and RL after the torch sweep bit for bit (the sweep gives the same
indices, and DA/RL are host numpy after it).
"""

import dataclasses
import math
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import straight_rect_sweep
from defensive_model_vae_tpu import dnda as jd
from defensive_model_vae_tpu.dnda import calculator as jcalc
from defensive_model_vae_tpu.dnda import core as jcore
from defensive_model_vae_tpu.dnda import frenet as jfr
from defensive_model_vae_tpu.dnda import paths as jpaths
from defensive_model_vae_tpu.dnda import risk as jrisk
from defensive_model_vae_tpu.dnda import spline as jsp
from defensive_model_vae_tpu_torch import dnda as td
from defensive_model_vae_tpu_torch.dnda import calculator as tcalc
from defensive_model_vae_tpu_torch.dnda import core as tcore
from defensive_model_vae_tpu_torch.dnda import device_sweep as tdev
from defensive_model_vae_tpu_torch.dnda import frenet as tfr
from defensive_model_vae_tpu_torch.dnda import paths as tpaths
from defensive_model_vae_tpu_torch.dnda import risk as trisk
from defensive_model_vae_tpu_torch.dnda import spline as tsp
from defensive_model_vae_tpu_torch.scripts import episodes

DTYPES = ("float32", "float64")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _same_tuple(a, b):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# spline, Frenet, curvature: the same native source, bit for bit
# ---------------------------------------------------------------------------

SPLINE_CASES = {
    "knots": (np.array([0.0, 1.0, 2.5, 4.0, 6.0]), np.array([1.0, -1.0, 0.5, 2.0, 1.5])),
    "cubic": (np.linspace(0, 5, 8), 2 * np.linspace(0, 5, 8) ** 3 - np.linspace(0, 5, 8) ** 2
              + 3 * np.linspace(0, 5, 8) - 1),
    "two_points": (np.array([0.0, 2.0]), np.array([1.0, 5.0])),
    "three_points": (np.array([0.0, 1.0, 3.0]), np.array([0.0, 2.0, -1.0])),
    "parabola": (np.linspace(-2, 2, 9), np.linspace(-2, 2, 9) ** 2),
}


@pytest.mark.parametrize("case", sorted(SPLINE_CASES))
def test_spline_matches_jax(case):
    x, y = SPLINE_CASES[case]
    got, want = tsp.fmm_spline_coeffs(x, y), jsp.fmm_spline_coeffs(x, y)
    assert _same_tuple(got, want)
    u = np.linspace(x[0], x[-1], 57)
    assert _same_tuple(tsp.spline_eval(x, y, *got, u), jsp.spline_eval(x, y, *want, u))
    assert _same(tsp.spline_curvature(x, y, u), jsp.spline_curvature(x, y, u))
    vals, _ = tsp.spline_eval(x, y, *got, x)
    assert np.allclose(vals, y, atol=1e-12)  # interpolates its knots


def test_spline_properties():
    """The JAX package's golden spline cases on the port: exact on cubics,
    a line through two points, curvature 2 of y = x² at 0."""
    x, y = SPLINE_CASES["cubic"]
    u = np.linspace(0, 5, 100)
    vals, _ = tsp.spline_eval(x, y, *tsp.fmm_spline_coeffs(x, y), u)
    assert np.allclose(vals, 2 * u**3 - u**2 + 3 * u - 1, atol=1e-8)
    b, c, d = tsp.fmm_spline_coeffs(*SPLINE_CASES["two_points"])
    assert np.allclose(b, 2.0) and np.allclose(c, 0) and np.allclose(d, 0)
    x, y = SPLINE_CASES["parabola"]
    _, k = tsp.spline_eval(x, y, *tsp.fmm_spline_coeffs(x, y), np.array([0.0]))
    assert np.isclose(k[0], 2.0, rtol=1e-2)
    with pytest.raises(ValueError, match="strictly increasing"):
        tsp.fmm_spline_coeffs(np.array([0.0, 1.0, 1.0]), np.zeros(3))


@pytest.mark.parametrize("n", [2, 3, 4, 7, 51, 400])
def test_native_spline_matches_numpy_version(n):
    """The native Thomas sweep against the numpy one (ulp drift through the
    length-n recurrence: rtol 1e-11, atol 1e-13, JAX's own limit), and the
    port's native result bit for bit JAX's."""
    rng = np.random.default_rng(1 + n)
    x = np.sort(rng.uniform(0, 100, n)) + np.arange(n) * 1e-3
    y = rng.normal(size=n)
    native = tsp.fmm_spline_coeffs(x, y)
    for a, b in zip(native, tsp.fmm_spline_coeffs_numpy(x, y)):
        assert np.allclose(a, b, rtol=1e-11, atol=1e-13)
    assert _same_tuple(native, jsp.fmm_spline_coeffs(x, y))


def test_frenet_matches_jax():
    t = np.linspace(0, 1, 150)
    pts = np.column_stack([30 * t, 5 * np.sin(4 * t)])
    straight = np.column_stack([np.linspace(0, 50, 200), np.zeros(200)])
    for p, m in ((pts, 40), (straight, 50), (pts[:20], 7)):
        assert _same_tuple(tfr.cartesian_to_frenet(p, m), jfr.cartesian_to_frenet(p, m))
        assert _same_tuple(tfr.cartesian_to_frenet_numpy(p, m),
                           jfr.cartesian_to_frenet_numpy(p, m))
    unit, arc, trans, bx, cx, by, cy, s = tfr.cartesian_to_frenet(straight, 50)
    assert np.isclose(arc, 50.0, atol=1e-6) and np.isclose(unit, 1.0, atol=1e-6)
    assert np.allclose(trans[:, 1], 0.0, atol=1e-9) and np.allclose(bx, 1.0, atol=1e-6)
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    assert np.isclose(tfr.cartesian_to_frenet(pts, 40)[1],
                      tfr.cartesian_to_frenet(pts @ R.T, 40)[1], rtol=1e-6)
    way, ua, al, sg = tfr.way_from_baseline(pts, 40)
    jway, jua, jal, jsg = jfr.way_from_baseline(pts, 40)
    assert (ua, al) == (jua, jal) and _same(sg, jsg)
    for f in dataclasses.fields(jway):
        assert _same(getattr(way, f.name), getattr(jway, f.name)), f.name


@pytest.mark.parametrize("n,m", [(3, 5), (12, 40), (60, 100), (200, 400)])
def test_native_frenet_matches_numpy_oracle(n, m):
    rng = np.random.default_rng(2 + n)
    pts = np.column_stack([np.cumsum(rng.uniform(0.3, 1.2, n)),
                           np.cumsum(rng.normal(0.0, 0.08, n))])
    for a, b in zip(tsp.frenet_native(pts, m), tfr.cartesian_to_frenet_numpy(pts, m)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11, atol=1e-12)


def test_native_batch_wrappers_match_scalar_and_jax():
    """The batched entry points equal the scalar ones bit for bit, and each
    equals JAX's binding of the same source."""
    rng = np.random.default_rng(3)
    xs, ys = [], []
    for n in (60, 101, 140):
        x = np.linspace(0.0, n * 0.9, n) + rng.normal(0, 1e-3, n)
        xs.append(x)
        ys.append(2.0 * np.sin(x / 25.0) + rng.normal(0, 1e-3, n))
    ks = tsp.max_curvature_batch_native(xs, ys)
    assert ks == jsp.max_curvature_batch_native(xs, ys)
    assert ks == [tsp.max_curvature_native(x, y) for x, y in zip(xs, ys)]
    batch = tsp.frenet_batch_native(xs, ys, 100)
    assert _same_tuple(batch, jsp.frenet_batch_native(xs, ys, 100))
    assert not batch[-1].any()
    for i, (x, y) in enumerate(zip(xs, ys)):
        one = tsp.frenet_native(np.column_stack([x, y]), 100)
        assert one[0] == batch[0][i] and one[1] == batch[1][i]
        assert _same(one[2][:, 0], batch[2][i]) and _same(one[3], batch[4][i])
    pts = np.column_stack([xs[1], ys[1]])
    fused = tsp.frenet_two_pass_native(pts, 50, 1.0)
    assert _same_tuple(fused[:8], jsp.frenet_two_pass_native(pts, 50, 1.0)[:8])
    m = round(tsp.frenet_native(pts, 50)[1] / 1.0)
    assert fused[8] == m and _same_tuple(fused[:8], tsp.frenet_native(pts, m))
    empty = tsp.frenet_batch_native([], [], 100)
    assert [a.shape[0] for a in empty] == [0] * 9


def test_curvature_and_cluster_helpers_match_jax():
    rng = np.random.default_rng(5)
    d = [rng.normal(size=(3, 41)) for _ in range(4)]
    d[0][0, :3] = 0.0  # the |d1x| <= eps branch
    for absolute in (False, True):
        assert _same_tuple(tfr.curvature_theta(*d, absolute),
                           jfr.curvature_theta(*d, absolute))
    base = np.column_stack([np.linspace(0, 80, 90), 1.5 * np.sin(np.linspace(0, 3, 90))])
    way, _, _, s_grid = tfr.way_from_baseline(base, 80)
    profs = [(rng.normal(0, 1e-4), rng.normal(0, 1e-2), rng.normal(0, 0.1), rng.normal())
             for _ in range(5)]
    xf, yf = tpaths._paths_xy_full(way, s_grid, profs)
    assert _same_tuple((xf, yf), jpaths._paths_xy_full(way, s_grid, profs))
    for j, (prof, seg) in enumerate(zip(profs, [20, 35, 50, 65, 80])):
        x1, y1 = tpaths._path_xy(way, s_grid, seg, *prof)
        assert _same(xf[j, : seg + 1], x1) and _same(yf[j, : seg + 1], y1)
        assert tpaths._max_curvature(x1, y1) == jpaths._max_curvature(x1, y1)
        assert np.isclose(tpaths._max_curvature(x1, y1),
                          tpaths._max_curvature_numpy(x1, y1), rtol=1e-9)
    theta, px, py = (rng.normal(0, s, (3, 41)) for s in (1.0, 10.0, 10.0))
    batched = tpaths._rect_sweep(px, py, theta, 7.2, 2.3)
    assert _same(batched, jpaths._rect_sweep(px, py, theta, 7.2, 2.3))
    for j in range(3):
        assert _same(batched[j], tpaths._rect_sweep(px[j], py[j], theta[j], 7.2, 2.3))


# ---------------------------------------------------------------------------
# prediction, SAT, polygon, risk level
# ---------------------------------------------------------------------------

def _vehicle_rows(seed, n=40):
    """Fuzzed vehicles, with the reference's corner cases first: at rest
    with pure lateral or longitudinal acceleration, and reversing."""
    rng = np.random.default_rng(seed)
    rows = [[3.0, -1.0, 4.0, 2.0, 0.0, 0.0, 0.0, 1.29, -2.893],
            [0.0, 0.0, 4.0, 2.0, 0.0, 0.0, 0.7, 0.0, 0.4],
            [5.0, 2.0, 4.0, 2.0, 2.0, -1.0, -2.0, 1.0, 0.1],
            [0.0, 0.0, 4.0, 2.0, 5.0, 0.0, -5.0, 0.0, 0.0]]
    for _ in range(n):
        sp = 0.0 if rng.random() < 0.4 else rng.uniform(0, 12)
        ang = rng.uniform(-np.pi, np.pi)
        rows.append([rng.uniform(-20, 20), rng.uniform(-10, 10), 4.0, 2.0,
                     sp * np.cos(ang), sp * np.sin(ang),
                     rng.choice([0.0, rng.uniform(-3, 3)]),
                     rng.choice([0.0, rng.uniform(-3, 3)]), rng.uniform(-np.pi, np.pi)])
    return np.asarray(rows)


def test_vehicle_prediction_matches_jax_and_torch():
    rows = _vehicle_rows(17)
    got = td.predict_surrounding_rectangles([td.SurroundingVehicle(*r) for r in rows], 3.0, 0.1)
    want = jd.predict_surrounding_rectangles([jd.SurroundingVehicle(*r) for r in rows], 3.0, 0.1)
    assert got.shape == (len(rows), 31, 2, 4) and _same(got, want)
    # the torch prediction on the CPU: the same rectangles to 1e-12 (its
    # atan, cos and sin are not numpy's to the last bit)
    t = torch.arange(31, dtype=torch.float64) * 0.1
    comp = tdev._predict_rects(torch.from_numpy(rows)[None], t)
    rect = torch.stack([torch.stack(comp[:4], -1), torch.stack(comp[4:], -1)], -2)[0]
    np.testing.assert_allclose(rect.numpy(), got, rtol=0, atol=1e-12)
    # constant velocity, and the freeze before a reversal
    cx = got[3, :, 0, :].mean(axis=1)
    assert cx.max() <= 2.5 + 1e-6 and np.isclose(cx[-1], cx.max())
    assert np.all(np.diff(cx) >= -1e-9)
    one = td.predict_surrounding_rectangles(
        [td.SurroundingVehicle(x=0, y=0, length=4, width=2, speed_x=10, speed_y=0)], 3.0, 0.1)
    assert np.allclose(one[0, :, 0, :].mean(axis=1), 10 * np.arange(31) * 0.1, atol=1e-9)


def _rect(cx, cy, L, W, theta):
    base = np.array([[L / 2, -L / 2, -L / 2, L / 2], [-W / 2, -W / 2, W / 2, W / 2]])
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]]) @ base + np.array([[cx], [cy]])


def test_sat_matches_jax_and_torch():
    a = _rect(0, 0, 4, 2, 0)
    assert td.sat_collision(a, _rect(3, 0, 4, 2, 0))
    assert not td.sat_collision(a, _rect(10, 0, 4, 2, 0))
    assert not td.sat_collision(a, _rect(0, 5, 4, 2, 0))
    rng = np.random.default_rng(0)
    A = np.stack([_rect(*rng.uniform(-3, 3, 2), 4, 2, rng.uniform(-3, 3)) for _ in range(256)])
    B = np.stack([_rect(*rng.uniform(-3, 3, 2), 4, 2, rng.uniform(-3, 3)) for _ in range(256)])
    got = td.sat_collision(A, B)
    assert _same(got, jd.sat_collision(A, B)) and got.any() and not got.all()
    assert _same(got, td.sat_collision(B, A))
    for dt in (torch.float64, torch.float32):
        comp = [torch.from_numpy(r).to(dt) for r in (A, B)]
        split = [([r[:, 0, k] for k in range(4)], [r[:, 1, k] for k in range(4)]) for r in comp]
        assert _same(tdev._sat_components(*split).numpy(), got)


def test_shoelace_and_drivable_area_match_jax():
    assert np.isclose(td.shoelace_area([0, 4, 4, 0], [0, 0, 3, 3]), 12.0)
    assert np.isclose(td.shoelace_area([0, 1, 2], [0, 1, 0]), 1.0)
    rng = np.random.default_rng(11)
    rects3 = [rng.normal(size=(9, 2, 4)) for _ in range(3)]
    cases = [[-1, 5, 7], [5, -1, 7], [5, 7, -1], [-1, -1, 4], [7, 5, 2],
             [2, 5, 7], [3, 3, 3], [0, 0, 0], [8, 0, 8], [-1, -1, -1]]
    for ci in cases:
        ci = np.asarray(ci)
        assert trisk.drivable_area(3, rects3, ci) == jrisk.drivable_area(3, rects3, ci)
    for ci in ([4], [-1], [0], [8]):
        ci = np.asarray(ci)
        assert trisk.drivable_area(1, rects3[:1], ci) == jrisk.drivable_area(1, rects3[:1], ci)


def test_drivable_area_matches_per_point_loops():
    """The vectorised stitching equals the original per-point loops, with
    the preserved quirk that ci == -1 of a neighbour wraps to the last
    rectangle."""
    def oracle(usable_num, ego_rects, ci):
        px, py, collided = [], [], []

        def add(r, col):
            px.append(r[0, col])
            py.append(r[1, col])

        for i in range(usable_num):
            if ci[i] < 0:
                collided.append(True)
                continue
            collided.append(False)
            rects = ego_rects[i]
            if i == 0:
                for j in range(ci[i] + 1):
                    add(rects[j], 1)
                add(rects[ci[i]], 0)
                if usable_num == 1:
                    for j in range(ci[i], -1, -1):
                        add(rects[j], 3)
                    continue
                if ci[i] > ci[i + 1]:
                    for j in range(ci[i], ci[i + 1] - 1, -1):
                        add(rects[j], 3)
            if 0 < i < usable_num - 1:
                if ci[i] > ci[i - 1]:
                    for j in range(ci[i - 1], ci[i] + 1):
                        add(rects[j], 0)
                    if ci[i] > ci[i + 1]:
                        for j in range(ci[i], ci[i + 1] - 1, -1):
                            add(rects[j], 3)
                elif ci[i] > ci[i + 1]:
                    for j in range(ci[i], ci[i + 1] - 1, -1):
                        add(rects[j], 3)
                elif ci[i] == ci[i + 1]:
                    add(rects[ci[i]], 3)
            if i == usable_num - 1 and usable_num > 1:
                if ci[i] > ci[i - 1]:
                    for j in range(ci[i - 1], ci[i] + 1):
                        add(rects[j], 0)
                for j in range(ci[i], -1, -1):
                    add(rects[j], 3)
                add(rects[0], 2)
        if usable_num == 0 or all(collided):
            return 0.0
        return td.shoelace_area(px, py)

    rng = np.random.default_rng(12)
    rects4 = [rng.normal(size=(9, 2, 4)) for _ in range(4)]
    for _ in range(40):
        ci = rng.integers(-1, 9, 4)
        assert trisk.drivable_area(4, rects4, ci) == oracle(4, rects4, ci), ci


def test_risk_level_matches_jax_and_raises_without_paths():
    rng = np.random.default_rng(13)
    k = list(rng.uniform(0.005, 0.1, 6))
    u = list(rng.uniform(0.6, 1.6, 4))
    ci = rng.integers(-1, 30, 4)
    args = ([0, 2, 3, 5], k, ci, u, 9.5, 3.0)
    assert trisk.risk_level(*args) == jrisk.risk_level(*args)
    with pytest.raises(ZeroDivisionError):
        trisk.risk_level([], [0.1, 0.2], np.array([]), [], 5.0, 3.0)


# ---------------------------------------------------------------------------
# the ego cluster and a frame's preparation, field by field
# ---------------------------------------------------------------------------

def _baseline(wiggle):
    bx = np.arange(600) * 0.25 - 20.0
    return np.column_stack([bx, 0.5 * np.sin(bx / 30) if wiggle else np.zeros(600)])


def _ego(x, y, speed, rel, acc):
    return dict(x=x, y=y, speed_x=speed * math.cos(rel), speed_y=speed * math.sin(rel),
                speed=speed, absolute_theta=0.0, acc=acc, init_q=y, relative_theta=rel,
                length=7.2, width=2.3, lane_posi=1)


PINNED_EGO = _ego(0.17449996586169148, 0.8701448475755365, 13.158535541215322,
                  -0.04972614998298519, 1.4296171063502774)
PINNED_SV = [[16.0141393484983, 1.7887666332953127, 4.0, 2.0, -1.946066276384646,
              0.0, 0.0, 0.0, 0.0]]


def _frames():
    """(name, ego kwargs, vehicle rows, wiggle): the pinned, no-obstacle and
    blocking frames of the JAX tests, an over-budget acceleration, and the
    seed-3 bounds frames."""
    ego0 = _ego(0.0, 0.0, 10.0, 0.0, 0.0)
    out = [("pinned", PINNED_EGO, PINNED_SV, False),
           ("free", ego0, np.zeros((0, 9)), False),
           ("far", ego0, [[60.0, 0.0, 4.0, 2.0, 0, 0, 0, 0, 0]], False),
           ("near", ego0, [[12.0, y, 4.0, 2.0, 0, 0, 0, 0, 0] for y in (-3.0, 0.0, 3.0)], False),
           ("overbudget", _ego(0.5, 0.2, 10.0, 0.02, 12.0),
            [[20.0, 0.5, 4.0, 2.0, -2.0, 0, 0, 0, 0]], False)]
    rng = np.random.default_rng(3)
    for i in range(5):
        ego = _ego(rng.uniform(-2, 2), rng.uniform(-1, 1), rng.uniform(5, 15),
                   rng.uniform(-0.05, 0.05), rng.uniform(-2, 2))
        sv = [[rng.uniform(10, 40), rng.uniform(-2, 2), 4.0, 2.0, rng.uniform(-3, 3),
               0.0, 0.0, 0.0, 0.0]]
        out.append((f"bounds{i}", ego, sv, bool(rng.integers(2))))
    return out


FRAMES = _frames()
ROAD = dict(cross_centerline=False, lane_num=2, lane_egodirect=2, lane_width=3.5,
            max_absolute_acc=9.8)


def _prep(pkg, ego, sv, wiggle):
    return pkg.core.prepare_frame(3.0, 0.1, pkg.Road(**ROAD), pkg.Vehicle(**ego),
                                  _baseline(wiggle), np.asarray(sv, float), 400)


def _assert_same_prep(got, want):
    assert len(got.ego_rects) == len(want.ego_rects)
    assert all(_same(a, b) for a, b in zip(got.ego_rects, want.ego_rects))
    for name in ("usable", "unit_arc_paths", "k_maxes", "ego_speed", "time_horizon",
                 "time_step"):
        assert getattr(got, name) == getattr(want, name), name
    assert _same(got.sur_array, want.sur_array)


@pytest.mark.parametrize("name", [f[0] for f in FRAMES])
def test_prepare_frame_and_da_rl_match_jax(name):
    """prepare_frame field by field, then DA and RL after the numpy sweep and
    after the torch sweep in each SAT dtype: bit for bit JAX's."""
    import defensive_model_vae_tpu.dnda as jpkg
    import defensive_model_vae_tpu_torch.dnda as tpkg

    _, ego, sv, wiggle = next(f for f in FRAMES if f[0] == name)
    got, want = _prep(tpkg, ego, sv, wiggle), _prep(jpkg, ego, sv, wiggle)
    _assert_same_prep(got, want)
    ref = jcore.finalize_frame(want, jcore.sweep_frame_host(want))
    assert tcore.finalize_frame(got, tcore.sweep_frame_host(got)) == ref
    for dt in DTYPES:
        ci = tcore.sweep_frames([got], device="cpu", sat_dtype=dt)[0]
        assert _same(ci, jcore.sweep_frame_host(want))
        assert tcore.finalize_frame(got, ci) == ref
    da, rl = ref
    assert 0.0 <= rl <= 1.0 and da >= 0.0
    assert td.drivable_area_risk_level(3.0, 0.1, td.Road(**ROAD), td.Vehicle(**ego),
                                       _baseline(wiggle), np.asarray(sv, float)) == ref


def test_pinned_da_rl_values():
    """The values pinned from live runs of the reference (DA 42.6688 ± 1e-3,
    RL 0.767949 ± 1e-5), after the torch sweep; a free road is safe; a wall
    of stopped vehicles ahead raises RL."""
    import defensive_model_vae_tpu_torch.dnda as tpkg

    def da_rl(name):
        _, ego, sv, wiggle = next(f for f in FRAMES if f[0] == name)
        prep = _prep(tpkg, ego, sv, wiggle)
        return tcore.finalize_frame(prep, tcore.sweep_frames([prep], device="cpu")[0])

    da, rl = da_rl("pinned")
    assert np.isclose(da, 42.6688, atol=1e-3) and np.isclose(rl, 0.767949, atol=1e-5)
    da, rl = da_rl("free")
    assert rl == 0.0 and da > 0
    assert da_rl("near")[1] > da_rl("far")[1]


def test_generate_ego_cluster_matches_jax():
    base = np.column_stack([np.arange(400) * 0.25, 0.3 * np.sin(np.arange(400) / 50)])
    for ego_kw, m in ((PINNED_EGO, None), (_ego(0.3, -0.4, 6.0, 0.03, -1.0), 60)):
        outs = []
        for fr, pk in ((tfr, td), (jfr, jd)):
            ua, _, trans, bx, cx, by, cy, s_grid = fr.cartesian_to_frenet(base, 99)
            way = fr.Way(trans[:, 0], trans[:, 1], bx, cx, by, cy).compute_curvature()
            ego = pk.Vehicle(**ego_kw)
            mod = tpaths if pk is td else jpaths
            outs.append(mod.generate_ego_cluster(ego, pk.Road(**ROAD), 1 / 6, ua, way, s_grid,
                                                 m or 99, 3.0, 0.1))
        got, want = outs
        assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
        assert got[4] == want[4]
        assert all(_same(a, b) for a, b in zip(got[1], want[1]))
        for wa, wb in zip(got[5], want[5]):
            for f in dataclasses.fields(wb):
                assert _same(getattr(wa, f.name), getattr(wb, f.name)), f.name


# ---------------------------------------------------------------------------
# the torch sweep: index-identical to JAX's device sweep and the numpy oracle
# ---------------------------------------------------------------------------

def _rand_path_rects(rng, n):
    th = np.cumsum(rng.normal(0, 0.05, n))
    x, y = np.cumsum(np.cos(th)), np.cumsum(np.sin(th))
    L, W = 4.8, 2.0
    base = np.array([[L / 2, -L / 2, -L / 2, L / 2], [-W / 2, -W / 2, W / 2, W / 2]])
    c, s = np.cos(th), np.sin(th)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
    return np.einsum("nij,jk->nik", R, base) + np.stack([x, y], axis=1)[:, :, None]


def _fuzz(seed, n_frames):
    """JAX ``tests/test_dnda.py:682-761``'s generator: paths of 20–119
    points, 1–8 paths, 0–6 accelerating or reversing vehicles."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_frames):
        n_paths, n_veh = int(rng.integers(1, 9)), int(rng.integers(0, 7))
        sur = np.zeros((n_veh, 9))
        for v in range(n_veh):
            sur[v] = [rng.uniform(0, 40), rng.uniform(-6, 6), 4.0, 2.0, rng.uniform(-8, 8),
                      rng.uniform(-2, 2), rng.uniform(-3, 3), rng.uniform(-1, 1),
                      rng.uniform(-3, 3)]
        out.append(dict(
            ego_rects=[_rand_path_rects(rng, int(rng.integers(20, 120)))
                       for _ in range(n_paths)],
            usable=list(range(n_paths)), unit_arc_paths=list(rng.uniform(0.6, 1.6, n_paths)),
            k_maxes=list(rng.uniform(0.005, 0.1, n_paths)), sur_array=sur,
            ego_speed=float(rng.uniform(0.5, 18)), time_horizon=3.0, time_step=0.1))
    return out


def _synthetic():
    return [
        dict(ego_rects=[straight_rect_sweep(60, 0.0), straight_rect_sweep(45, 0.0)],
             usable=[0, 1], unit_arc_paths=[1.0, 1.3], k_maxes=[0.01, 0.02],
             sur_array=np.array([[20.0, 0.0, 4.0, 2.0, 0.0, 0.0, 0.0, 0.0, 0.0]]),
             ego_speed=10.0, time_horizon=3.0, time_step=0.1),
        dict(ego_rects=[straight_rect_sweep(60, 0.0)], usable=[0], unit_arc_paths=[1.0],
             k_maxes=[0.01], sur_array=np.zeros((0, 9)), ego_speed=5.0,
             time_horizon=3.0, time_step=0.1),
        # a zero-point path beside a real one (JAX test_dnda.py:484)
        dict(ego_rects=[np.zeros((0, 2, 4)), straight_rect_sweep(40)], usable=[0, 1],
             unit_arc_paths=[1.0, 1.0], k_maxes=[0.01, 0.01],
             sur_array=np.array([[15.0, 0.0, 4.0, 2.0, 0, 0, 0, 0, 0]], float),
             ego_speed=8.0, time_horizon=3.0, time_step=0.1),
    ]


def _sweep_all(frames, dt):
    """(torch on the CPU, JAX's device sweep, the port's numpy oracle)."""
    tp = [tcore.FramePrep(**f) for f in frames]
    jp = [jcore.FramePrep(**f) for f in frames]
    return (tcore.sweep_frames(tp, device="cpu", sat_dtype=dt),
            jcore.sweep_frames(jp, device=True, sat_dtype=dt),
            tcore.sweep_frames(tp, host=True))


CASES = {"synthetic": lambda: _synthetic(), "fuzz7": lambda: _fuzz(7, 25),
         "fuzz300": lambda: _fuzz(19, 300)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_sweep_index_identical(case, dt):
    """Every frame's collision indices equal JAX's device sweep's and the
    numpy oracle's.  fuzz300 crosses the 256-frame chunk boundary."""
    frames = CASES[case]()
    got, jax_dev, host = _sweep_all(frames, dt)
    assert len(got) == len(frames)
    for i, (g, j, h) in enumerate(zip(got, jax_dev, host)):
        assert _same(g, h) and np.array_equal(g, j), (i, g, j, h)
    if case == "synthetic":
        assert got[0][0] < 20  # the stationary vehicle at x = 20 blocks the path
        assert got[1][0] == int(np.ceil(5.0 * 3.0 / 1.0))  # no vehicle: the default
        assert got[2][0] == int(np.ceil(8.0 * 3.0 / 1.0))  # zero points: the default
    else:
        # the fuzz hits: some paths end before their default
        assert any((g < np.ceil(f["ego_speed"] * 3.0 / np.asarray(f["unit_arc_paths"]))).any()
                   for g, f in zip(got, frames))


def test_torch_sweep_padding_and_refusals():
    frames = _fuzz(23, 3)
    padded = tdev.pad_frames([f["ego_rects"] for f in frames],
                             [f["unit_arc_paths"] for f in frames],
                             [f["ego_speed"] for f in frames],
                             [f["sur_array"] for f in frames], 3.0, 0.1, "float32")
    F, _, _, P, N = padded.ego.shape
    assert (F, P, N) == (256, 8, 128) and padded.ego.dtype == torch.float32
    assert padded.sur.shape[1] == 8 and padded.arcs[3:].eq(1.0).all()
    n0 = frames[0]["ego_rects"][0].shape[0]
    # the last rectangle replicated into the padding
    last = torch.from_numpy(frames[0]["ego_rects"][0][-1].astype(np.float32))
    assert torch.equal(padded.ego[0, :, :, 0, -1], last)
    assert int(padded.npts[0, 0]) == n0
    preps = [tcore.FramePrep(**f) for f in frames]
    assert tcore.sweep_frames([], device="cpu") == []
    mixed = [preps[0], dataclasses.replace(preps[1], time_horizon=2.0)]
    with pytest.raises(ValueError, match="mixed-horizon"):
        tcore.sweep_frames(mixed, device="cpu")
    with pytest.raises(TypeError, match="create_mesh"):
        tcore.sweep_frames(preps, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        for call in (lambda: tcore.sweep_frames(preps), lambda: tcore.sweep_frames([])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


# ---------------------------------------------------------------------------
# episodes: written from the committed windows, and with traces written back
# ---------------------------------------------------------------------------

TRACES = "results/GeneratedData"


@pytest.fixture(scope="module")
def sut_dir(tmp_path_factory):
    """Four written episodes (one a scenario) and, for the first committed
    trace of sce1 and sce3, an episode with that trace written back, named
    as the scoring driver expects: ``<model>_<town>_<trial>.csv``."""
    from conftest import REPO_ROOT
    from defensive_model_vae_tpu_torch import scenarios
    from defensive_model_vae_tpu_torch.sut import (
        expected_csv_name, parse_tracked_npy_name, writeback_npy_to_csv)

    root = tmp_path_factory.mktemp("sut")
    src, out = root / "src", root / "score"
    out.mkdir()
    for key in ("sce1", "sce2", "sce3", "sce4"):
        sce = scenarios.get(key)
        windows = np.load(sce.fixture_windows)[:2]
        paths = episodes.write_episodes(windows, key, str(root / "episodes"))
        shutil.copy(paths[0], out / f"EP_{sce.town}_1.csv")
        if key in ("sce1", "sce3"):
            name = sorted(f for f in os.listdir(REPO_ROOT / TRACES)
                          if f.startswith(f"tracked_trajectory_{key}_"))[0]
            town_dir = src / sce.town
            town_dir.mkdir(parents=True)
            shutil.copy(paths[1], town_dir / expected_csv_name(*parse_tracked_npy_name(name)))
            wb = writeback_npy_to_csv(REPO_ROOT / TRACES / name, src, root / "def")
            shutil.copy(wb, out / f"DEF_{sce.town}_1.csv")
    return out


def _episode_files(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".csv"))


def test_process_episode_matches_jax_host_path(sut_dir):
    """Each episode scored by the torch sweep (CPU) and by the host path
    equals JAX's host path: frames and DNDA values bit for bit."""
    from defensive_model_vae_tpu_torch import scenarios

    scored = 0
    for name in _episode_files(sut_dir):
        path = str(sut_dir / name)
        key = scenarios.get(name.split("_")[1]).key
        want = jcalc.process_episode(path, key, max_frames=12, device=False)
        for kw in (dict(device="cpu"), dict(host=True)):
            got = tcalc.process_episode(path, key, max_frames=12, **kw)
            assert got.frames == want.frames and got.dnda == want.dnda, (name, kw)
        scored += len(want.frames)
    assert scored > 0


@pytest.mark.parametrize("processes", [1, 2])
def test_score_directory_matches_jax(sut_dir, tmp_path, processes):
    """The summary rows (torch sweep on the CPU, and the host pool) equal
    JAX's host pool's, and the summary CSV is the same file."""
    want = jd.score_directory(sut_dir, out_csv=str(tmp_path / "j.csv"), processes=processes,
                              device=False, max_frames=6)
    for kw in (dict(device="cpu"), dict(host=True)):
        got = td.score_directory(sut_dir, out_csv=str(tmp_path / "t.csv"),
                                 processes=processes, max_frames=6, **kw)
        assert got == want
        assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert len(want) == 6 and {r["model"] for r in want} == {"EP", "DEF"}


def test_score_directory_empty_dir(tmp_path):
    """No episode-pattern CSV: a header-only summary, as JAX writes."""
    (tmp_path / "exp_11_control_Town05_3.csv").write_text("frame,id\n1,0\n")
    rows = td.score_directory(tmp_path, out_csv=str(tmp_path / "summary.csv"), device="cpu")
    assert rows == []
    lines = (tmp_path / "summary.csv").read_text().strip().splitlines()
    assert lines == ["model,scenario,trial,max_dnda,frames,file_path"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            td.score_directory(tmp_path)


def test_baselines_match_jax():
    for key in ("sce1", "sce2", "sce3", "sce4"):
        b = td.baseline_for(key)
        assert b.ndim == 2 and b.shape[1] == 2 and len(b) > 1000
        assert _same(b, jd.baseline_for(key))
        assert _same_tuple(tcalc._rotate_to_x(b), jcalc._rotate_to_x(b))


# ---------------------------------------------------------------------------
# the spline library's build
# ---------------------------------------------------------------------------

def test_spline_library_is_built_into_the_port_build_dir():
    from conftest import REPO_ROOT

    path = tsp.build()
    assert path.parent == REPO_ROOT / "defensive_model_vae_tpu_torch" / "build"
    assert path.name.startswith("libdmvspline_") and path.exists()
    assert tsp.build() == path


def test_spline_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A spline library that does not build raises with the compiler's
    output, at the first call that needs it; nothing falls back to numpy."""
    bad = tmp_path / "dnda_spline.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tsp, "SOURCE", bad)
    monkeypatch.setattr(tsp, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tsp, "_lib", None)
    with pytest.raises(RuntimeError, match="building the DNDA spline library failed:\n.*error"):
        tsp.fmm_spline_coeffs(np.arange(5.0), np.zeros(5))
    with pytest.raises(RuntimeError, match="building the DNDA spline library failed"):
        tfr.cartesian_to_frenet(np.column_stack([np.arange(9.0), np.zeros(9)]), 8)
    monkeypatch.setattr(tsp, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        tsp.build()


# ---------------------------------------------------------------------------
# the synthetic SUT frames of scripts/dnda_sweep.py, and chip_smoke's phase
# ---------------------------------------------------------------------------

def test_synthetic_inputs_prepare_like_jax():
    """The script's candidate frames, prepared by the port and by JAX: the
    same refusals and the same FramePrep field by field."""
    import itertools

    from defensive_model_vae_tpu_torch.scripts import dnda_sweep

    prepared = 0
    for road, ego, rot, sur in itertools.islice(dnda_sweep.synthetic_inputs(5), 24):
        outs = []
        for pkg in (td, jd):
            try:
                outs.append(pkg.core.prepare_frame(3.0, 0.1, pkg.Road(**road),
                                                   pkg.Vehicle(**ego), rot, sur, 400))
            except (ValueError, ZeroDivisionError) as e:
                outs.append(type(e))
        got, want = outs
        if isinstance(want, type):
            assert got is want
            continue
        _assert_same_prep(got, want)
        prepared += 1
    assert prepared >= 20


@pytest.mark.parametrize("dt", DTYPES)
def test_synthetic_frames_sweep_matches_jax(dt):
    """Sixty-four of the script's frames: the torch sweep index for index
    JAX's device sweep and the numpy oracle; some paths hit a vehicle."""
    from defensive_model_vae_tpu_torch.scripts import dnda_sweep

    frames = [dataclasses.asdict(p) for p in dnda_sweep.synthetic_frames(64, seed=1)]
    got, jax_dev, host = _sweep_all(frames, dt)
    for g, j, h in zip(got, jax_dev, host):
        assert _same(g, h) and np.array_equal(g, j)
    assert sum(int((g < np.ceil(f["ego_speed"] * 3.0 / np.asarray(f["unit_arc_paths"]))).sum())
               for g, f in zip(got, frames)) > 0


def test_dnda_sweep_script_on_the_cpu(capsys):
    import json

    from defensive_model_vae_tpu_torch.scripts import dnda_sweep

    assert dnda_sweep.main(["--device", "cpu", "--frames", "16", "--tile", "40",
                            "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["frames"] == 16
    for dt in DTYPES:
        assert out[dt]["frames"] == 40 and out[dt]["chunks"] == 1
        assert out[dt]["peak_mem_mb"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dnda_sweep.main(["--frames", "4"])


def test_chip_smoke_dnda_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's dnda phase end to end with the device set to the CPU
    and its sizes cut (48 frames, 300 tiled, one timed rep): every check it
    makes passes, and the SUT chain scores frames."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DNDA_FRAMES", 48)
    monkeypatch.setattr(chip_smoke, "DNDA_TILE", 300)
    monkeypatch.setattr(chip_smoke, "DNDA_REPS", 1)
    trees = episodes.write_fixture_trees(str(tmp_path))
    info = chip_smoke.dnda_phase(np, torch, torch.device("cpu"), trees, "cpu")
    assert info["frames"] == 48 and info["paths_hit"] > 0
    assert info["sweep_float32"]["frames"] == 300 and info["sweep_float32"]["chunks"] == 2
    sut = info["sut"]
    assert len(sut["traces"]) == 8 and sut["frames_scored"] > 0
    assert sum(1 for c in sut["finite_metrics"].values() if c["TTC"] is None) == 2
