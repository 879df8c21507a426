"""The tracker's step function and the host side of its captured form, on
the CPU (the graphs themselves need the card:
``tests/test_torch_mpc_graph_card.py``).

``_simulate_eager`` loops ``_step`` (the function the card captures) and is
held against JAX's ``_simulate_batch_jit`` on the same numpy inputs at the
tolerance of ``tests/test_torch_mpc.py::test_track_batch_matches_jax``
(states and controls atol 1e-3 over the whole simulation), including the
first solve's Δu₀ exemption.  The graph cache and the replay loop run here
with a stand-in graph whose replay is one eager ``_step``: the loop around
the replays must then give the eager loop's bits.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.control import MPCConfig as JMPCConfig
from defensive_model_vae_tpu.control.mpc import _simulate_batch_jit

from defensive_model_vae_tpu_torch.control import PathReference, mpc
from defensive_model_vae_tpu_torch.ops import lu_solve as lus

TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(windows, idxs, steps, cfg, last=(0.0, 0.0)):
    """(states0, refs, last0) as numpy float32 from fixture windows."""
    s0, refs = [], []
    for i in idxs:
        wp = windows[i][:, [1, 2, 0]].astype(float)
        wp[0, 2] = 0.0
        v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
        init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
        refs.append(PathReference(wp, init).build(steps, cfg.prediction_horizon, cfg.dt))
        s0.append(mpc._initial_tracker_state(init))
    last0 = np.tile(np.asarray(last, np.float32), (len(idxs), 1))
    return (np.stack(s0).astype(np.float32), np.stack(refs).astype(np.float32), last0)


def _jax(cfg, s0, refs, last0):
    jcfg = JMPCConfig(prediction_horizon=cfg.prediction_horizon,
                      control_horizon=cfg.control_horizon, dt=cfg.dt,
                      freeze_jacobian=cfg.freeze_jacobian)
    s, c = _simulate_batch_jit(jcfg, jnp.asarray(s0), jnp.asarray(refs), jnp.asarray(last0))
    return np.asarray(s), np.asarray(c)


def _eager(cfg, s0, refs, last0):
    s, c = mpc._simulate_eager(cfg, torch.tensor(s0), torch.tensor(refs), torch.tensor(last0))
    return s.numpy(), c.numpy()


@pytest.mark.parametrize("cfg", [
    mpc.MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02),
    mpc.MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05),
    mpc.MPCConfig(prediction_horizon=10, control_horizon=10, dt=0.05, freeze_jacobian=True),
], ids=["serve", "short", "frozen_full_hold"])
def test_step_loop_matches_jax(windows_sce1, cfg):
    s0, refs, last0 = _inputs(windows_sce1, (1, 3, 7), 96, cfg)
    s_t, c_t = _eager(cfg, s0, refs, last0)
    s_j, c_j = _jax(cfg, s0, refs, last0)
    assert s_t.shape == s_j.shape == (3, 97, 4) and c_t.shape == c_j.shape == (3, 96, 2)
    assert np.allclose(s_t, s_j, atol=TOL) and np.allclose(c_t, c_j, atol=TOL)


def test_first_solve_is_free_of_the_du0_penalty(windows_sce1):
    """With a last control far from the path's need, the first solve's Δu₀
    exemption moves the first control by far more than the tolerance; the
    port's first controls equal JAX's, and a run that does not clear the
    penalty on its first solve misses them."""
    cfg = mpc.MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02)
    s0, refs, last0 = _inputs(windows_sce1, (1, 3), 8, cfg, last=(-6.0, 0.4))
    s_t, c_t = _eager(cfg, s0, refs, last0)
    s_j, c_j = _jax(cfg, s0, refs, last0)
    assert np.allclose(c_t, c_j, atol=TOL) and np.allclose(s_t, s_j, atol=TOL)

    prob = mpc._problem(cfg, torch.device("cpu"))
    buf = mpc._StepBuffers(cfg, 2, torch.device("cpu"))
    buf.start(torch.tensor(s0), torch.tensor(last0))
    assert bool(buf.first)
    buf.first.fill_(False)  # the penalty kept on the first solve
    buf.ref.copy_(torch.tensor(refs)[:, 0])
    mpc._step(prob, buf)
    assert np.abs(buf.last.numpy() - c_j[:, 0]).max() > 100 * TOL
    buf.start(torch.tensor(s0), torch.tensor(last0))
    mpc._step(prob, buf)
    assert not bool(buf.first)  # the step clears it
    assert np.array_equal(buf.last.numpy(), c_t[:, 0])


def test_du_pair_selects_the_built_pairs_bit_for_bit():
    prob = mpc._problem(mpc.MPCConfig(), torch.device("cpu"))
    for flag, w0 in ((True, 0.0), (False, 1.0)):
        jac, w = prob.du_pair(torch.tensor(flag))
        assert torch.equal(jac, prob.du_jac[w0][0]) and torch.equal(w, prob.du_jac[w0][1])


def test_problem_is_built_once_per_config_and_device():
    cfg = mpc.MPCConfig(prediction_horizon=12, control_horizon=6)
    a = mpc._problem(cfg, torch.device("cpu"))
    assert mpc._problem(mpc.MPCConfig(prediction_horizon=12, control_horizon=6),
                        torch.device("cpu")) is a
    assert mpc._problem(mpc.MPCConfig(), torch.device("cpu")) is not a


def test_lu_solve_on_the_cpu_is_its_plain_version():
    g = torch.Generator().manual_seed(0)
    J = torch.randn((5, 80, 40), generator=g)
    H = J.transpose(1, 2) @ J + 1e-3 * torch.eye(40)
    b = torch.randn((5, 40, 1), generator=g)
    assert torch.equal(lus.lu_solve(H, b), torch.linalg.solve_ex(H, b)[0])


class _EagerGraph:
    """A stand-in for a captured step: replay runs the step eagerly."""

    made = []

    def __init__(self, cfg, B, dev):
        if B == 13:
            raise RuntimeError("refused")
        prob = mpc._problem(cfg, dev)
        self.buf = mpc._StepBuffers(cfg, B, dev)
        outer = self

        class _Replay:
            def replay(self):
                mpc._step(prob, outer.buf)

        self.graph = _Replay()
        _EagerGraph.made.append((cfg, B))


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(mpc, "_StepGraph", _EagerGraph)
    monkeypatch.setattr(mpc, "_graphs", type(mpc._graphs)())
    _EagerGraph.made = []
    return _EagerGraph.made


def test_replay_loop_gives_the_eager_loops_bits(windows_sce1, stand_in_graphs):
    cfg = mpc.MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05)
    s0, refs, last0 = (torch.tensor(a) for a in _inputs(windows_sce1, (1, 3), 20, cfg,
                                                        last=(0.5, 0.0)))
    eager = mpc._simulate_eager(cfg, s0, refs, last0)
    captures, steps = mpc.graph_captures, mpc.graph_steps
    for _ in range(2):  # the second call reuses the cached buffers
        got = mpc._simulate_captured(cfg, s0, refs, last0)
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert stand_in_graphs == [(cfg, 2)]
    assert mpc.graph_captures - captures == 1
    assert mpc.graph_steps - steps == 2 * 20
    assert not got[0].is_inference()


def test_threads_that_miss_together_capture_once(windows_sce1, stand_in_graphs,
                                                monkeypatch):
    """Two threads that ask for one new key while a capture is slow: one
    capture, both answers the eager loop's, the counts exact."""

    class _SlowGraph(_EagerGraph):
        def __init__(self, *a):
            time.sleep(0.2)
            super().__init__(*a)

    monkeypatch.setattr(mpc, "_StepGraph", _SlowGraph)
    cfg = mpc.MPCConfig(prediction_horizon=10, control_horizon=5, dt=0.05)
    s0, refs, last0 = (torch.tensor(a) for a in _inputs(windows_sce1, (1, 3), 8, cfg))
    eager = mpc._simulate_eager(cfg, s0, refs, last0)
    captures, steps = mpc.graph_captures, mpc.graph_steps
    got = [None, None]

    def run(k):
        got[k] = mpc._simulate_captured(cfg, s0, refs, last0)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert stand_in_graphs == [(cfg, 2)] and mpc.graph_captures - captures == 1
    assert mpc.graph_steps - steps == 2 * 8
    assert all(torch.equal(a, b) for g in got for a, b in zip(g, eager))


def test_graph_cache_keeps_its_bound_and_evicts_the_oldest(stand_in_graphs, monkeypatch):
    monkeypatch.setattr(mpc, "GRAPH_CACHE_MAX", 2)
    cfg, dev = mpc.MPCConfig(), torch.device("cpu")
    a = mpc._step_graph(cfg, 2, dev)
    b = mpc._step_graph(cfg, 3, dev)
    assert mpc._step_graph(cfg, 2, dev) is a  # a hit, now the newest
    mpc._step_graph(cfg, 4, dev)
    assert list(mpc._graphs) == [(cfg, 2, dev), (cfg, 4, dev)]
    assert b not in mpc._graphs.values()
    assert mpc._step_graph(cfg, 3, dev) is not b  # captured anew
    assert len(mpc._graphs) == 2 and len(stand_in_graphs) == 4


def test_a_refused_capture_raises_naming_the_shape(stand_in_graphs):
    with pytest.raises(RuntimeError, match="batch 13 on cpu failed: RuntimeError: refused"):
        mpc._simulate_captured(mpc.MPCConfig(), torch.zeros((13, 4)),
                               torch.zeros((13, 64, 31, 2)), torch.zeros((13, 2)))
    assert not mpc._graphs
