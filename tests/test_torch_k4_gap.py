"""The logic of ``scripts/k4_gap.py`` on the CPU, where K4's wrapper runs
its plain version: a stand-in kernel that differs from the plain version
in one unit of one row only when that row is live must be found by the row
search and named by the unit search; the emulated FMA chain must stay
within its rounding of the float64 sum."""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import init_params
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
from defensive_model_vae_tpu_torch.scripts import k4_gap as kg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("row, layer, unit", [(413, "dec_1", 5), (40, "enc_2", 77)])
def test_row_and_unit_search_find_a_planted_flip(monkeypatch, row, layer, unit):
    dev = torch.device("cpu")
    nv, packed = fs._scale_inputs(kg.corpus(2 * kg.TILE), kg.CFG, kg.TILE, None, None, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), kg.CFG, dev))
    plain = fs._grad_epoch_call
    bi = 2 * ft._LAYERS.index(layer) + 1

    def stand_in(plist, packed, *args):
        g, row_out = plain(plist, packed, *args)
        if packed[row, kg.MASK_COL] > 0:
            g = list(g)
            g[bi] = g[bi].clone()
            g[bi][0, unit] += 1e-3
        return g, row_out

    monkeypatch.setattr(fs, "_grad_epoch_call", stand_in)
    gk, gp = kg.both(plist, packed, float(nv), "prng", None)
    ref_max = [max(float(b.abs().max()), 1e-12) for b in gp]
    assert max(kg.gaps(gk, gp, ref_max)) > kg.K4_TOL
    rows, calls = kg.carriers(plist, packed, float(nv), "prng", None, ref_max, kg.K4_TOL / 2)
    assert rows == [row] and calls <= 2 * int(np.ceil(np.log2(packed.shape[0]))) + 1
    found = kg.flipped_unit(*kg.both(plist, packed, float(nv), "prng", None, [row]))
    assert (found["layer"], found["unit"], found["units_over"]) == (layer, unit, 1)


def test_fma_chain_is_one_rounding_a_step():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal(256).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((256, 16)).astype(np.float32))
    got = kg.fma_chain(a, w).double()
    exact = a.double() @ w.double()
    terms = (a.double()[:, None] * w.double()).abs().sum(0)
    assert torch.all((got - exact).abs() <= 256 * 2.0 ** -24 * terms)
    # each step adds the exact product: a one-term chain is the rounded product
    one = kg.fma_chain(a[:1], w[:1])
    assert torch.equal(one, (a[0].double() * w[0].double()).float())
