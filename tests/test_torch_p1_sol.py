"""P1-sol, the K3 ablation's compute floor, and its two checks, on the CPU.

The kernel (``csrc/p1_sol.cu``, ``wgmma`` with the chain kept in registers)
runs on the card (``tests/test_torch_ablation_card.py``, ``chip_smoke.py``);
here its wrapper runs the plain version, and what the checks rest on is
held (``scripts/sol_checks.py``):

- (a) the order-free case: its plain version against the JAX script's
  ``_ablation_call(mode="sol")`` in interpret mode bit for bit (at a row
  count that JAX's tile divides), its total exact (equal to the float64 sum
  of its terms), the row count derived from the bound with the kernel's
  last tile ragged, and both deliberate errors missing it;
- (b) ``ORDER_TOL`` at least twice the plain version's spread under
  permuted summation orders on the checks' 8,448-row corpora, and below
  the plain version without one product;
- the wrapper's refusals before any build or launch, the library's C
  arguments, and the refusal of a library whose SASS holds no HGMMA.
"""

import ctypes
import importlib.util
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from conftest import REPO_ROOT
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights

from defensive_model_vae_tpu_torch.models import CVAEConfig
from defensive_model_vae_tpu_torch.ops import _build
from defensive_model_vae_tpu_torch.ops import scale_ablation as sa
from defensive_model_vae_tpu_torch.scripts import sol_checks as solc

CFG = CVAEConfig()
N_CHAIN = sa.sol_chain_length(CFG)
CPU = torch.device("cpu")
_P = ctypes.c_void_p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exact():
    return solc.exact_case(CPU, N_CHAIN)


@pytest.fixture(scope="module")
def exact16():
    """The order-free case at a row count that JAX's smoke tile (16)
    divides."""
    return solc.exact_case(CPU, N_CHAIN, multiple=16)


@pytest.fixture(scope="module")
def jax_ablation():
    """The JAX ablation script under ``--smoke`` (CPU, interpret mode, tile
    16, 9 epochs), loaded as tests/test_torch_ablation.py loads it."""
    argv = sys.argv
    sys.argv = ["scale_ablation.py", "--smoke"]
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_scale_ablation_sol", REPO_ROOT / "scripts" / "scale_ablation.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


# ---- (a) the order-free case ---------------------------------------------------

def test_order_free_plain_matches_jax_bit_for_bit(jax_ablation, exact16):
    """The same inputs through JAX's Pallas kernel (interpret mode) and the
    port: every product one exact term and every partial sum exact, so the
    totals are equal bit for bit, epoch by epoch."""
    packed, w_in, w_ch, rows, _ = exact16
    assert rows % jax_ablation.TILE == 0
    jb = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    j = np.asarray(jax_ablation._ablation_call(
        jb(packed), (jb(w_in), jb(w_ch)), "sol", JCVAEConfig(), JLossWeights(), float(rows),
        jnp.bfloat16, n_chain=N_CHAIN))[:jax_ablation.EPOCHS]
    t = sa.p1_sol(packed, w_in, w_ch, N_CHAIN, jax_ablation.EPOCHS, jax_ablation.TILE)
    assert np.array_equal(t.numpy()[:, 0], j[:, 0])
    assert not np.any(t.numpy()[:, 1:])


def test_order_free_total_is_exact(exact):
    """The plain total equals the float64 sum of its terms, in any tiling,
    and the rows stay within the derived bound: n·M ≤ 2^24·q."""
    packed, w_in, w_ch, rows, most = exact
    terms = sa._sol_h(packed, w_in, w_ch, N_CHAIN)
    exact64 = float(terms.double().sum())
    for tile in (4, rows // 4, rows):
        assert float(sa._p1_sol_plain(packed, w_in, w_ch, N_CHAIN, 1, tile)[0, 0]) == exact64
    assert float(terms.flip(0).sum()) == exact64  # another order, the same bits
    assert rows == most // solc.EXACT_MULTIPLE * solc.EXACT_MULTIPLE
    assert most < 131072  # the bench's rows are too many


def test_order_free_case_ends_in_a_ragged_tile(exact):
    """The kernel's last 64-row tile is short, and its bytes end inside a
    16-byte chunk: the case runs the kernel's tail copy and its row guard."""
    packed, _, _, rows, _ = exact
    last = rows % solc.KERNEL_ROWS
    assert rows > solc.KERNEL_ROWS and last
    assert last * packed.shape[1] * packed.element_size() % 16


def test_order_free_rounding_fires(exact):
    """Each product's output is one exact term, and its rounding to bf16
    moves values: the chain without the rounding differs on some of them."""
    packed, w_in, w_ch, _, _ = exact
    h = packed.float() @ w_in.float()
    assert torch.equal(h, h.to(torch.bfloat16).float())  # small integers, exact
    rounded = h.to(torch.bfloat16).float() @ w_ch.float()
    moved = 0
    for _ in range(N_CHAIN - 1):
        unrounded = rounded @ w_ch.float()
        rounded = rounded.to(torch.bfloat16).float() @ w_ch.float()
        moved += int((rounded != unrounded).sum())
    assert moved > 0
    assert torch.equal(rounded, sa._sol_h(packed, w_in, w_ch, N_CHAIN))


@pytest.mark.parametrize("wrong", ["one_product_fewer", "no_bf16_rounding"])
def test_each_deliberate_error_misses_the_order_free_total(exact, wrong):
    packed, w_in, w_ch, _, _ = exact
    plain = float(sa._p1_sol_plain(packed, w_in, w_ch, N_CHAIN, 1, packed.shape[0])[0, 0])
    assert solc.wrong_sums(packed, w_in, w_ch, N_CHAIN)[wrong] != plain


def test_exact_rows_bound_fails_past_it():
    """At the derived count the bound holds; a count twice as large breaks
    it (the quantity n·M/q grows with n)."""
    w_in, w_ch = solc.exact_weights(41, CPU)
    most = solc.exact_rows(w_in, w_ch, N_CHAIN)
    vals = torch.tensor(solc.EXACT_VALUES, dtype=torch.float32)
    x = vals[:, None].expand(len(vals), 41).to(torch.bfloat16).contiguous()
    f = sa._sol_h(x, w_in, w_ch, N_CHAIN).double()
    q = 2.0 ** min(solc._low_bit(v) for v in f[f != 0].tolist())
    m = float(f.abs().max(dim=0).values.sum())
    assert most * m <= 2 ** 24 * q < 2 * most * m


# ---- (b) the random case's limit -----------------------------------------------

@pytest.mark.parametrize("rows,seed,eps_seed,tile",
                         [c for c in solc.CORPORA if c[0] == 8448])
def test_order_tol_between_the_spread_and_one_product_fewer(rows, seed, eps_seed, tile):
    """ORDER_TOL holds twice the plain version's largest gap against itself
    under ORDER_SEEDS permuted hidden indices, and the chain without one
    product lies far outside it."""
    packed = solc.corpus(rows, seed, eps_seed, tile, CPU)
    w_in, w_ch = solc.chip_weights(packed.shape[1], CPU)
    spread, gaps = solc.order_noise(packed, w_in, w_ch, N_CHAIN, tile)
    tol = solc.ORDER_TOL[rows]
    assert len(gaps) == len(solc.ORDER_SEEDS) >= 16
    assert 0 < 2 * spread <= tol
    ref = float(sa._p1_sol_plain(packed, w_in, w_ch, N_CHAIN, 1, tile)[0, 0])
    terms = float(sa._sol_h(packed, w_in, w_ch, N_CHAIN).abs().sum())
    fewer = solc.wrong_sums(packed, w_in, w_ch, N_CHAIN)["one_product_fewer"]
    assert abs(fewer - ref) / terms > 100 * tol


def test_permuted_hidden_index_is_the_same_function():
    """The permutation moves only the summation order: in float64 the
    permuted chain's total is the original's to rounding."""
    packed = solc.corpus(352, 0, 1, 352, CPU)
    w_in, w_ch = solc.chip_weights(packed.shape[1], CPU)
    p = torch.randperm(128, generator=torch.Generator().manual_seed(0))
    h = packed.double() @ w_in.double()
    hp = packed.double() @ w_in[:, p].double()
    for _ in range(3):
        h, hp = h @ w_ch.double(), hp @ w_ch[p][:, p].double()
    assert float((h[:, p] - hp).abs().max()) <= 1e-12 * float(h.abs().max())


def test_check_runs_the_plain_version_on_the_cpu(exact):
    """The whole check, the plain version in the kernel's place: both cases
    pass and both deliberate errors are caught."""
    packed = solc.corpus(8448, 0, 1, 352, CPU)
    w_in, w_ch = solc.chip_weights(packed.shape[1], CPU)
    row, ok, caught = solc.check(sa.p1_sol, packed, w_in, w_ch, N_CHAIN, 352, 2, exact)
    assert ok and caught and row["order_free"]["bits_equal"]
    assert row["order"]["sum_gap"] == 0.0


# ---- the wrapper and the library --------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("P1-sol reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_start_build", refuse)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,args,match", [
    ("float32 w_in", (_bf(64, 41), torch.zeros(41, 128), _bf(128, 128), 23), "bf16"),
    ("float32 w_chain", (_bf(64, 41), _bf(41, 128), torch.zeros(128, 128), 23), "bf16"),
    ("w_in rows", (_bf(64, 41), _bf(40, 128), _bf(128, 128), 23), r"\(41, 128\)"),
    ("w_chain shape", (_bf(64, 41), _bf(41, 128), _bf(128, 64), 23), "w_chain"),
    ("float32 corpus", (torch.zeros(64, 41), _bf(41, 128), _bf(128, 128), 23), "bf16"),
    ("too wide", (_bf(64, 65), _bf(65, 128), _bf(128, 128), 23), "at most 64"),
    ("negative chain", (_bf(64, 41), _bf(41, 128), _bf(128, 128), -1), "n_chain"),
])
def test_wrapper_refuses_before_any_build(no_build, case, args, match):
    with pytest.raises(ValueError, match=match):
        sa.p1_sol(*args, 1, 16)


def test_wrapper_refuses_weights_on_another_device(no_build):
    with pytest.raises(ValueError, match="one device"):
        sa.p1_sol(_bf(64, 41), _bf(41, 128).to("meta"), _bf(128, 128), 23, 1, 16)


def test_library_is_registered_with_its_c_arguments():
    objects, entries = _build.KERNELS["p1_sol"]
    assert objects == (("p1_sol.cu", ()),)
    restype, args = entries["p1_sol"]
    assert restype is ctypes.c_int
    # corpus, width, rows | w_in, w_chain, chain | epochs, partials, grid | metrics, stream
    assert args == [_P, ctypes.c_int, ctypes.c_longlong, _P, _P, ctypes.c_int,
                    ctypes.c_int, _P, ctypes.c_int, _P, _P]
    assert entries["p1_sol_grid"] == (ctypes.c_int, [ctypes.c_int, ctypes.c_int])
    assert entries["p1_sol_partials"] == (ctypes.c_longlong, [ctypes.c_int])
    assert entries["p1_sol_cuda_launches"] == (ctypes.c_longlong, [])
    assert "p1_sol" not in _build.KERNELS["scale_ablation"][1]


def test_sources_hold_wgmma_and_no_fma_sol_kernel():
    """P1-sol's source runs its products on wgmma with A from registers; the
    FMA sol kernel is gone from the ablation's source."""
    src = (_build.CSRC / "p1_sol.cu").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "{%64, %65, %66, %67}" in src  # the A operand: four registers
    abl = (_build.CSRC / "scale_ablation.cu").read_text()
    assert "sol_kernel" not in abl and "p1_sol(" not in abl


@pytest.fixture
def fake_sol_library(monkeypatch):
    """A stand-in P1-sol library whose SASS holds the counts the test sets;
    → (the library, those counts, the reads)."""
    lib, ops, reads = types.SimpleNamespace(), {"HMMA": 0, "HGMMA": 0}, []
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "_lib_path", lambda name: "libp1_sol_fake.so")
    monkeypatch.setattr(sa, "_SOL_HGMMA", {})
    monkeypatch.setattr(_build, "tensor_core_ops",
                        lambda p: reads.append(p) or dict(ops))
    return lib, ops, reads


@pytest.mark.parametrize("hmma", [0, 5])
def test_library_without_hgmma_is_refused(fake_sol_library, hmma):
    """No HGMMA in the SASS, with or without other tensor-core mma."""
    _, ops, _ = fake_sol_library
    ops["HMMA"] = hmma
    with pytest.raises(RuntimeError, match="HGMMA"):
        sa._sol_lib()


def test_library_with_hgmma_is_taken_and_read_once(fake_sol_library):
    lib, ops, reads = fake_sol_library
    ops["HGMMA"] = 61
    assert sa._sol_lib() is lib and sa._sol_lib() is lib
    assert len(reads) == 1  # the SASS is read once a process


def test_cuda_launches_reads_both_libraries(monkeypatch):
    libs = {"scale_ablation": types.SimpleNamespace(sa_cuda_launches=lambda i: 10 + i)}
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.setitem(_build._LOADED, "p1_sol",
                        types.SimpleNamespace(p1_sol_cuda_launches=lambda: 7))
    assert sa.cuda_launches() == {"stream": 10, "fwd": 11, "dx": 12, "p2": 13, "sol": 7}


def test_cuda_launches_does_not_load_the_sol_library(monkeypatch):
    """Before P1-sol's library is loaded its count is 0, and reading the
    counts does not build or load it."""
    libs = {"scale_ablation": types.SimpleNamespace(sa_cuda_launches=lambda i: 0)}
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.delitem(_build._LOADED, "p1_sol", raising=False)
    assert sa.cuda_launches()["sol"] == 0


def test_script_prints_the_spread_on_the_cpu(capsys, monkeypatch):
    """The script's line on the CPU at cut sizes: each corpus's spread
    beside its limit, the order-free case exact."""
    monkeypatch.setattr(solc, "CORPORA", ((352, 0, 1, 352),))
    monkeypatch.setattr(solc, "ORDER_TOL", {352: 1.0})
    monkeypatch.setattr(solc, "ORDER_SEEDS", (0, 1))
    assert solc.main(["--device", "cpu"]) == 0
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sol_checks"]
    assert out["device"] == "cpu" and len(out["corpora"][0]["gaps"]) == 2
    assert out["order_free"]["exact"] and out["order_free"]["rows"] > 0
