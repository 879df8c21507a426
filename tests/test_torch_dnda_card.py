"""The DNDA collision sweep on the card, index-identical to the numpy oracle.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they also run where only the port's dependencies
are installed:

    python -m pytest --noconftest -m gpu tests/test_torch_dnda_card.py -q

The rule is JAX's own: the card's collision indices equal the numpy
``collision_indices`` frame by frame, in float32 and float64 SAT.  CUDA's
atan, cos and sin are not correctly rounded where numpy's are, so a corner
on an exact edge could flip a comparison; a difference is run down, not
loosened.
"""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.dnda import core

DTYPES = ("float32", "float64")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_path_rects(rng, n):
    th = np.cumsum(rng.normal(0, 0.05, n))
    x, y = np.cumsum(np.cos(th)), np.cumsum(np.sin(th))
    L, W = 4.8, 2.0
    base = np.array([[L / 2, -L / 2, -L / 2, L / 2], [-W / 2, -W / 2, W / 2, W / 2]])
    c, s = np.cos(th), np.sin(th)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
    return np.einsum("nij,jk->nik", R, base) + np.stack([x, y], axis=1)[:, :, None]


def _fuzz(seed, n_frames):
    """The JAX tests' fuzz generator (``tests/test_dnda.py:682-761``)."""
    rng = np.random.default_rng(seed)
    preps = []
    for _ in range(n_frames):
        n_paths, n_veh = int(rng.integers(1, 9)), int(rng.integers(0, 7))
        sur = np.zeros((n_veh, 9))
        for v in range(n_veh):
            sur[v] = [rng.uniform(0, 40), rng.uniform(-6, 6), 4.0, 2.0, rng.uniform(-8, 8),
                      rng.uniform(-2, 2), rng.uniform(-3, 3), rng.uniform(-1, 1),
                      rng.uniform(-3, 3)]
        preps.append(core.FramePrep(
            ego_rects=[_rand_path_rects(rng, int(rng.integers(20, 120)))
                       for _ in range(n_paths)],
            usable=list(range(n_paths)), unit_arc_paths=list(rng.uniform(0.6, 1.6, n_paths)),
            k_maxes=list(rng.uniform(0.005, 0.1, n_paths)), sur_array=sur,
            ego_speed=float(rng.uniform(0.5, 18)), time_horizon=3.0, time_step=0.1))
    return preps


def _straight(n):
    rects = np.zeros((n, 2, 4))
    rects[:, 0] = np.arange(n)[:, None] + np.array([1.0, -1.0, -1.0, 1.0])
    rects[:, 1] = np.array([-0.5, -0.5, 0.5, 0.5])
    return rects


def _synthetic():
    stopped = np.array([[20.0, 0.0, 4.0, 2.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    return [
        core.FramePrep([_straight(60), _straight(45)], [0, 1], [1.0, 1.3], [0.01, 0.02],
                       stopped, 10.0, 3.0, 0.1),
        core.FramePrep([_straight(60)], [0], [1.0], [0.01], np.zeros((0, 9)), 5.0, 3.0, 0.1),
        core.FramePrep([np.zeros((0, 2, 4)), _straight(40)], [0, 1], [1.0, 1.0], [0.01, 0.01],
                       stopped - [5.0, 0, 0, 0, 0, 0, 0, 0, 0], 8.0, 3.0, 0.1),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["synthetic", "fuzz7", "fuzz300"])
def test_card_sweep_index_identical_to_numpy(case, dt):
    _cuda()
    preps = {"synthetic": _synthetic, "fuzz7": lambda: _fuzz(7, 25),
             "fuzz300": lambda: _fuzz(19, 300)}[case]()
    got = core.sweep_frames(preps, device="cuda", sat_dtype=dt)
    want = core.sweep_frames(preps, host=True)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not np.array_equal(g, w)]
    assert len(got) == len(preps) and not bad, [(i, got[i], want[i]) for i in bad[:5]]


@pytest.mark.gpu
def test_card_sweep_pinned_frame():
    """The frame pinned from live runs of the reference: DA 42.6688 ± 1e-3,
    RL 0.767949 ± 1e-5 after the card's sweep, and bit for bit the host's."""
    import math

    from defensive_model_vae_tpu_torch.dnda import Road, Vehicle

    _cuda()
    speed, rel = 13.158535541215322, -0.04972614998298519
    ego = Vehicle(x=0.17449996586169148, y=0.8701448475755365, length=7.2, width=2.3,
                  speed=speed, speed_x=speed * math.cos(rel), speed_y=speed * math.sin(rel),
                  acc=1.4296171063502774, init_q=0.8701448475755365, lane_posi=1,
                  absolute_theta=0.0, relative_theta=rel)
    baseline = np.column_stack([np.arange(600) * 0.25 - 20.0, np.zeros(600)])
    sv = np.array([[16.0141393484983, 1.7887666332953127, 4.0, 2.0, -1.946066276384646,
                    0.0, 0.0, 0.0, 0.0]])
    prep = core.prepare_frame(3.0, 0.1, Road(False, 2, 2, 3.5, 9.8), ego, baseline, sv, 400)
    host = core.finalize_frame(prep, core.sweep_frame_host(prep))
    for dt in DTYPES:
        da, rl = core.finalize_frame(prep, core.sweep_frames([prep], sat_dtype=dt)[0])
        assert (da, rl) == host
        assert abs(da - 42.6688) <= 1e-3 and abs(rl - 0.767949) <= 1e-5
