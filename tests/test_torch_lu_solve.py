"""The tracker's LU solve (``ops/lu_solve.py``) on the CPU: the wrapper's
contract, its choice of kernel form and instance (mirrored from
``csrc/lu_solve.cu``), its plain version against JAX's
``jnp.linalg.solve``, and the systems ``scripts/lu_checks.py`` holds the
two forms to on the card, with the emulation of their arithmetic.

Tolerances: a solve's normwise backward error |Hx - g| / (|H| |x| + |g|)
(infinity norms, float64) within n·2^-24, what float32 LU with partial
pivoting guarantees (growth factor 1), as ``chip_smoke.py`` holds the
kernel.  The emulation's fmaf is held bit for bit to the exactly rounded
sum (``fractions``).
"""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu_torch.control import mpc
from defensive_model_vae_tpu_torch.control.sweep import COMBOS
from defensive_model_vae_tpu_torch.ops import _build
from defensive_model_vae_tpu_torch.ops import lu_solve as lus
from defensive_model_vae_tpu_torch.scripts import lu_checks as lc

U = 2.0 ** -24
CPU = torch.device("cpu")


def _backward(H, g, x):
    Hd, gd, xd = H.double(), g.double(), x.double()
    r = (Hd @ xd - gd).abs().amax(dim=(1, 2))
    norm = Hd.abs().sum(dim=2).amax(dim=1) * xd.abs().amax(dim=(1, 2)) + gd.abs().amax(dim=(1, 2))
    return float((r / norm).max())


def _system(B=3, n=12, seed=0):
    gen = torch.Generator().manual_seed(seed)
    J = torch.randn((B, 2 * n, n), generator=gen)
    return (J.transpose(1, 2) @ J + 1e-3 * torch.eye(n)).contiguous(), \
        torch.randn((B, n, 1), generator=gen)


# ---- the wrapper's contract ---------------------------------------------------

@pytest.mark.parametrize("bad", ["dtype_H", "dtype_g", "square", "g_shape", "ndim"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    H, g = _system()
    H, g = {"dtype_H": (H.double(), g), "dtype_g": (H, g.double()),
            "square": (H[:, :, :-1].contiguous(), g), "g_shape": (H, g[:, :, 0]),
            "ndim": (H[0], g[0])}[bad]
    with pytest.raises(ValueError):
        lus.lu_solve(H, g)


def test_wrapper_refuses_non_contiguous_inputs():
    H, g = _system()
    with pytest.raises(ValueError, match="contiguous"):
        lus.lu_solve(H.transpose(1, 2), g)
    g2 = torch.randn((3, 12, 2))[:, :, :1]
    with pytest.raises(ValueError, match="contiguous"):
        lus.lu_solve(H, g2)


@pytest.mark.parametrize("form", ["fast", "REG", ""])
def test_an_unknown_form_is_refused(form):
    H, g = _system()
    with pytest.raises(ValueError, match="form"):
        lus.lu_solve(H, g, form=form)
    with pytest.raises(ValueError, match="form"):
        lus.instance(12, form)


@pytest.mark.parametrize("n", [0, 129, 200])
def test_orders_outside_the_kernel_are_refused(n):
    with pytest.raises(ValueError, match="orders"):
        lus.instance(n)


@pytest.mark.parametrize("n", [65, 100, 128])
def test_the_register_form_refuses_orders_above_its_largest_bound(n):
    with pytest.raises(ValueError, match="register form"):
        lus.instance(n, "reg")
    assert lus.instance(n) == ("smem", lus.NMAX)


def test_the_choice_by_order():
    for n in range(1, lus.NMAX + 1):
        form, bound = lus.instance(n)
        if n <= lus.REG_BOUNDS[-1]:
            assert form == "reg" and bound == min(b for b in lus.REG_BOUNDS if b >= n)
        else:
            assert (form, bound) == ("smem", lus.NMAX)
        assert lus.instance(n, "smem") == ("smem", lus.NMAX)
    # the orders the repo runs: serving's and the sweep's
    assert [lus.instance(2 * m)[1] for _, m in COMBOS] == [16, 32, 40, 64]


def test_the_choice_mirrors_the_kernel_source():
    """REG_BOUNDS, LU_NMAX, the form numbers and the C entries the wrapper
    calls are the kernel source's."""
    src = (_build.CSRC / "lu_solve.cu").read_text()
    bounds = re.search(r"REG_BOUNDS\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in bounds.split(",")) == lus.REG_BOUNDS
    assert int(re.search(r"LU_NMAX = (\d+)", src).group(1)) == lus.NMAX
    forms = re.search(r"LU_SMEM = (\d+), LU_REG = (\d+)", src)
    assert (lus.FORMS.index("smem"), lus.FORMS.index("reg")) == \
        (int(forms.group(1)), int(forms.group(2)))
    for b in lus.REG_BOUNDS:
        assert f"case {b}: return launch_reg<{b}>" in src
    entries = _build.KERNELS["lu_solve"][1]
    assert len(entries["lu_solve_batched"][1]) == 7  # H, g, x, B, n, form, stream
    for fn in entries:
        assert f"int {fn}(" in src


@pytest.mark.parametrize("form", [None, "reg", "smem"])
def test_cpu_tensors_go_to_the_plain_version(form):
    H, g = _system(B=5, n=40)
    assert torch.equal(lus.lu_solve(H, g, form=form), torch.linalg.solve_ex(H, g)[0])


def test_plain_version_against_jax():
    """The port's solve (its plain version on the CPU) and JAX's
    jnp.linalg.solve on the tracker's serve systems: both within n·u of
    backward error, and within the 2·κ·n·u·|x| that two such solves can
    part by."""
    H, g = lc.lm_systems(4, CPU)
    x = lus.lu_solve(H, g)
    xj = torch.from_numpy(np.array(jnp.linalg.solve(H.numpy(), g.numpy())))
    n = H.shape[1]
    assert _backward(H, g, x) <= n * U and _backward(H, g, xj) <= n * U
    Hd = H.double()
    kappa = float((Hd.abs().sum(dim=2).amax(dim=1)
                   * torch.linalg.inv(Hd).abs().sum(dim=2).amax(dim=1)).max())
    assert float((x - xj).abs().max()) <= 2 * kappa * n * U * float(x.abs().max())


# ---- the systems the card holds the forms to ----------------------------------

@pytest.mark.parametrize("n", lc.TIE_ORDERS)
def test_tie_cases_tie_exactly_and_are_well_posed(n):
    H, g = lc.tie_case(n)
    H64 = H.astype(np.float64)
    col = np.abs(H64[:, :, 0])
    rows = lc.tie_rows(n)
    assert len(rows) >= 3 and rows[0] > 0
    assert np.all(col[:, rows] == lc.TIE_VALUE)
    assert np.all(np.sort(col, axis=1)[:, -len(rows) - 1] < lc.TIE_VALUE)
    signs = np.sign(H64[:, rows, 0])
    assert np.all(signs[:, :-1] == -signs[:, 1:])  # alternating
    off = np.delete(H64, 0, axis=2)
    assert not np.any(off == np.round(off))  # every other entry non-integer
    assert np.all(np.linalg.cond(H64) < 1e4)
    if n > 34:
        assert 33 in rows  # lane 1's second row beside row 1


@pytest.mark.parametrize("P,M", COMBOS)
def test_sweep_systems_are_non_singular(P, M):
    cfg = mpc.MPCConfig(prediction_horizon=P, control_horizon=M, dt=lc.tp.CFG.dt)
    H, g = lc.lm_systems(3, CPU, cfg)
    assert H.shape == (3, 2 * M, 2 * M) and g.shape == (3, 2 * M, 1)
    H64 = H.double()
    assert torch.allclose(H64, H64.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(H64).min()) > 0  # JᵀJ + λI
    assert bool(torch.isfinite(g).all())
    assert _backward(H, g, lc.lu_emulate(H, g)) <= 2 * M * U


def test_range_case_leaves_the_register_forms_fast_divisions():
    H, g = lc.lm_systems(2, CPU)
    Hs = H * lc.RANGE_SCALE
    assert float(Hs[Hs != 0].abs().max()) >= 2.0 ** 60
    # a power of two: the same solve, scaled
    assert torch.equal(lc.lu_emulate(Hs, g * lc.RANGE_SCALE), lc.lu_emulate(H, g))


def test_fmaf_is_rounded_once():
    rng = np.random.default_rng(3)
    N = 3000
    a = (rng.standard_normal(N) * 2.0 ** rng.integers(-20, 20, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(N) * 1e-7)).astype(np.float32)
    c[::3] = rng.standard_normal(N)[::3].astype(np.float32)
    got = lc._fmaf(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(N):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        want = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.array(v).view(np.int32)) & 1))
        assert got[i] == want, (a[i], b[i], c[i])


@pytest.mark.parametrize("n", lc.TIE_ORDERS)
def test_emulation_solves_and_the_wrong_pivot_rule_moves_bits(n):
    H, g = (torch.from_numpy(v) for v in lc.tie_case(n))
    first, last = lc.lu_emulate(H, g), lc.lu_emulate(H, g, "last")
    assert _backward(H, g, first) <= n * U and _backward(H, g, last) <= n * U
    assert not torch.equal(first, last)


def test_emulation_against_the_plain_version():
    H, g = lc.lm_systems(4, CPU)
    x, p = lc.lu_emulate(H, g), lus.lu_solve(H, g)
    n = H.shape[1]
    assert _backward(H, g, x) <= n * U
    assert float((x - p).abs().max()) <= 1e-4 * float(p.abs().max())


def test_cases_cover_every_instance_and_order():
    cases = lc.cases(CPU)
    names = [c[0] for c in cases]
    assert len(set(names)) == len(names)
    orders = {c[1].shape[1] for c in cases}
    assert orders == {2 * m for _, m in COMBOS}
    assert {lus.instance(n)[1] for n in orders} == set(lus.REG_BOUNDS)
    assert {c[1].shape[0] for c in cases if c[0].startswith("tracker")} == \
        set(lc.TRACKER_ROWS)
    assert any(c[0].startswith("range") for c in cases)
