"""Each plain reference against the port's CPU path at small sizes."""

import json

import numpy as np
import pytest
import torch

from port_bench import corpus
from port_bench.manifest import HERE, ROOT
from port_bench.reference import compare
from port_bench.reference import conv_cvae as ref_conv
from port_bench.reference import cvae as ref_cvae
from port_bench.reference import serve as ref_serve

CVAE = json.loads((HERE / "configs/cvae.json").read_text())
CONV = json.loads((HERE / "configs/conv_cvae.json").read_text())


def _port_leaves(params, names):
    return [params[n][k] for n in names for k in ("w", "b")]


@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_cvae_reference_follows_the_port(precision):
    from defensive_model_vae_tpu_torch.ops.fused_scale import fused_train_scale

    w = corpus.scale_corpus(256, 7)
    params, hist = fused_train_scale(w, epochs=3, seed=11, tile=64, compute_dtype=precision,
                                     device="cpu")
    fmt = precision or "float32"
    ref = ref_cvae.train_job(w, 11, 3, CVAE, fmt, fmt, "cpu")
    assert compare.loss_gap(hist["total"], ref["losses"], 1) < 1e-6
    assert compare.change_gap(_port_leaves(params, ref_cvae.LAYERS), ref["init"], ref["final"],
                              ref["grad0"]) < (1e-5 if precision is None else 1e-3)
    assert [a.shape for a in ref["init"]] == [a.shape for a in _port_leaves(params, ref_cvae.LAYERS)]


def test_conv_reference_follows_the_port():
    from defensive_model_vae_tpu_torch.models.conv_cvae import ConvCVAEConfig
    from defensive_model_vae_tpu_torch.train.train import TrainConfig, train_conv

    w = corpus.random_walks(48, 50, 3)
    params, hist, _ = train_conv(w, ConvCVAEConfig(), TrainConfig(epochs=3, seed=5),
                                 kld_weight=CONV["kld_weight"], device="cpu")
    ref = ref_conv.train_job(w, 5, CONV, 3, "cpu")
    names = [n for n, _ in ref_conv.layer_shapes(CONV)]
    assert compare.loss_gap(hist["total"], ref["losses"]) < 1e-5
    assert compare.change_gap(_port_leaves(params, names), ref["init"], ref["final"],
                              ref["grad0"]) < 1e-4


def test_serve_reference_follows_the_port():
    from defensive_model_vae_tpu_torch.serving import build_serve_fn

    from port_bench.drivers.serve_http import rows_arrays, start_rows

    windows = np.load(ROOT / "fixtures/trajectory_sce2_cond.npy")
    starts, inits = rows_arrays(start_rows(windows, np.arange(8) * 2))
    fn = build_serve_fn(str(ROOT / "results/checkpoints/sce2"), 24, 0.025, device="cpu")
    states, controls = fn(2**33 + 5, starts, inits)
    params = ref_serve.load_params(str(ROOT / "results/checkpoints/sce2"), "cpu")
    rs, rc = ref_serve.serve(params, 2**33 + 5, starts, inits, 24, 0.025, CVAE)
    assert float((states[..., :2] - rs[..., :2]).norm(dim=-1).max()) < 1e-3
    assert float((controls - rc).abs().max()) < 1e-2


def test_serve_draws_and_jacobian():
    from defensive_model_vae_tpu_torch.ops.fused_trainer import philox_normal_on

    assert torch.equal(ref_serve.philox_normals(2**40 + 3, 64, 8, "cpu"),
                       philox_normal_on(2**40 + 3, 0, 64, 8, "cpu"))
    g = torch.Generator().manual_seed(0)
    B, P, M, dt = 3, 30, 20, 0.02
    u = (torch.rand((B, M, 2), generator=g) * 2 - 1) * torch.tensor([8.0, 0.6])
    u[0, 3, 0], u[1, 5, 1] = 7.0, -0.5  # on the bounds: slope ½
    state, ref = torch.rand((B, 4), generator=g) * 3, torch.rand((B, P + 1, 2), generator=g)
    last = torch.rand((B, 2), generator=g)
    for first in (True, False):
        jac = ref_serve.jacobian(u, state, first, P, M, dt)
        for b in range(B):
            row = lambda uu: ref_serve.batched_residuals(  # noqa: E731
                uu[None], state[b:b + 1], ref[b:b + 1], last[b:b + 1], first, P, M, dt)[0]
            auto = torch.autograd.functional.jacobian(row, u[b]).reshape(-1, 2 * M)
            assert torch.allclose(jac[b], auto, atol=1e-6)
