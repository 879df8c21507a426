"""``scripts/k3_order_noise.py`` on the CPU: the hidden-unit permutation that
moves the plain versions' summation order keeps the function, the order-free
case is order-free and reaches every layer, and ``chip_smoke.py``'s bf16
one-epoch limits (twice the plain version's own order spread) still see
the card tests' deliberate error, a 32-row step left out of 9,000
(``tests/test_torch_scale_card.py::
test_a_plain_version_without_one_step_fails_the_limits``).
"""

import importlib.util
import json

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch.models import init_params
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
from defensive_model_vae_tpu_torch.scripts import k3_order_noise as k3on

CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_permuted_hidden_units_are_the_same_function():
    nv, packed = fs._scale_inputs(k3on.card_corpus(64), k3on.CFG, 64, None, None, CPU)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), k3on.CFG, CPU))
    src = fs._eps_source("prng", k3on.CFG, 64, 64, None, 4, CPU)
    g, r = fs._plain_grad_epoch(plist, packed, 64, k3on.CFG, k3on.LW, float(nv), None, src)
    perms = k3on.perms_of(3, CPU)
    gp, rp = fs._plain_grad_epoch(k3on.permute(plist, perms), packed, 64, k3on.CFG, k3on.LW,
                                  float(nv), None, src)
    assert torch.allclose(rp, r, rtol=1e-5)
    for a, b in zip(gp, k3on.permute(g, perms)):
        assert torch.allclose(a, b, atol=1e-5 * float(b.abs().max()) + 1e-12)


def test_order_free_case_is_order_free_and_reaches_every_layer():
    assert k3on.order_free_self_check(CPU, 2) == {"float32": True, "bfloat16": True}
    plist, packed, nv = k3on.exact_case(CPU, "bfloat16")
    grads, row = k3on.exact_plain(plist, packed, nv, "bfloat16")
    assert all(int((g != 0).sum()) > 0 for g in grads) and torch.isfinite(row).all()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_k3_order_free_case_is_order_free_and_sees_a_left_out_step(dtype):
    """One epoch of K3's plain version on the order-free case: Adam moves
    the params, permuted hidden units give the permuted params and the same
    loss row bit for bit, and the case without one 32-row step is unequal."""
    plist, packed, nv = k3on.exact_case(CPU, dtype)
    params, metrics = k3on.exact_k3_plain(plist, packed, nv, dtype)
    assert any(not torch.equal(a, b) for a, b in zip(params, plist))
    perms = k3on.perms_of(1, CPU)
    pp, mp = k3on.exact_k3_plain(k3on.permute(plist, perms), packed, nv, dtype)
    assert all(torch.equal(a, b) for a, b in zip(pp, k3on.permute(params, perms)))
    assert torch.equal(mp, metrics)
    assert k3on.exact_k3_row((params, metrics), (params, metrics))[1]
    wrong = packed.clone()
    wrong[k3on.EXACT_DROP, 32] = 0
    assert not k3on.exact_k3_row((params, metrics),
                                 k3on.exact_k3_plain(plist, wrong, nv, dtype))[1]


def test_new_bf16_limits_still_see_a_left_out_step():
    tol = _chip_smoke().K3_TOL[("bfloat16", 1)]
    n, tile, cd = 9000, 352, "bfloat16"
    nv, packed = fs._scale_inputs(k3on.card_corpus(n), k3on.CFG, tile, cd, None, CPU)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), k3on.CFG, CPU))
    eps_all = fs.hbm_noise(4, 1, packed.shape[0], k3on.CFG.latent_dim, cd, CPU)
    wrong = packed.clone()
    wrong[32 * 100:32 * 101, 32] = 0  # the mask column
    args = (4, k3on.CFG, k3on.LW, 1, 1e-3, tile, float(nv), cd, "hbm", eps_all)
    gap = k3on.k3_spread(fs._fused_scale_call_plain(plist, wrong, *args),
                         fs._fused_scale_call_plain(plist, packed, *args))
    assert gap["params_frac"] > tol["params_frac"] and gap["metrics_rel"] > tol["metrics_rel"]
    for dtype in (None, cd):
        xp, xpk, xnv = k3on.exact_case(CPU, dtype)
        xw = xpk.clone()
        xw[k3on.EXACT_DROP, 32] = 0
        _, equal = k3on.exact_row(k3on.exact_plain(xp, xw, xnv, dtype),
                                  k3on.exact_plain(xp, xpk, xnv, dtype))
        assert not equal


def test_script_prints_its_spreads(capsys):
    assert k3on.main(["--seeds", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    doc = json.loads(out[-1])["k3_order_noise"]
    cases = {(r["case"], r.get("epochs")) for r in doc["rows"]}
    assert cases == {("k3_vs_plain", 1), ("k3_vs_plain", 20), ("ablation_vs_plain", 1),
                     ("ablation_vs_plain", 3), ("k4_float32", None)}
    assert all(np.isfinite(v) for r in doc["rows"] for v in r["spread"].values())
