"""The K3 ablation path in the port, against the JAX package: the manual
backward's ablation levers, K3's ``_ablate`` knobs, the ablation's own
kernels P1 (stream, sol, fwd, dx) and the probe kernel P2, and the ported
scripts.

On the CPU every wrapper runs its plain version; the CUDA kernels are held
against those plain versions on the card (tests/test_torch_ablation_card.py
and chip_smoke.py).  The same numpy inputs and JAX's initial params go into
both packages.  Tolerances:

- levers: loss components rtol 1e-5; each gradient array to 1e-5 (float32)
  or 1e-2 (bf16, JAX's own bf16 rule: both round the same float32 values,
  but a value one float32 ulp apart can round to the neighbouring bf16
  number) of its own max;
- K3's knobs (N 64, tile 16, 3 epochs, packed ε, as the JAX ablation's
  smoke): params atol 1e-5, a hundredth of one Adam step, and metrics
  rtol 1e-5 — the two sides run the same per-tile arithmetic and differ
  in summation order only;
- P1 and P2 (JAX's smoke shape N 64, 9 epochs, tile 16): each sum within
  1e-5 of the sum of the absolute values of its terms (float32 sums in
  another order); the loss components rtol 1e-5.
"""

import ast
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from conftest import REPO_ROOT
from defensive_model_vae_tpu.models import CVAEConfig as JCVAEConfig
from defensive_model_vae_tpu.models import LossWeights as JLossWeights
from defensive_model_vae_tpu.models import init_params as j_init_params
from defensive_model_vae_tpu.ops import fused_scale as jfs
from defensive_model_vae_tpu.ops import fused_trainer as jft
from defensive_model_vae_tpu.ops.manual_grad import manual_value_and_grad as j_manual

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights
from defensive_model_vae_tpu_torch.ops import fused_scale as tfs
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.ops import scale_ablation as tsa
from defensive_model_vae_tpu_torch.ops.manual_grad import manual_value_and_grad
from defensive_model_vae_tpu_torch.scripts import k3_digest, noise_consumer_probe, scale_ablation

CFG, LW = CVAEConfig(), LossWeights()
KNOBS = ("noadam", "noacc", "biasdot", "chaincd", "nodw", "fwdonly", "dwT")
N, EPOCHS, TILE = 64, 9, 16  # the JAX ablation's smoke shape

_j_manual = jax.jit(j_manual, static_argnums=(4, 5),
                    static_argnames=("n_valid", "compute_dtype", "bias_via_dot",
                                     "chain_cd", "grads_mode"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed):
    jp = jft._flatten_params(j_init_params(jax.random.PRNGKey(seed), JCVAEConfig()))
    return jp, [torch.tensor(np.asarray(a)) for a in jp]


def _corpus(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 2.0, (n, CFG.seq_len)), axis=1)
    t -= t[:, :1]
    xy = rng.normal(0.0, 5.0, (n, CFG.seq_len, 2)).cumsum(axis=1)
    return np.concatenate([t[..., None], xy], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ablation():
    """The JAX ablation script, loaded as tests/test_scripts.py:593-601
    loads it: under ``--smoke`` (CPU, interpret mode, N 64, 9 epochs, tile
    16)."""
    argv = sys.argv
    sys.argv = ["scale_ablation.py", "--smoke"]
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_scale_ablation", REPO_ROOT / "scripts" / "scale_ablation.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    assert (mod.N, mod.EPOCHS, mod.TILE) == (N, EPOCHS, TILE)
    return mod


@pytest.fixture(scope="module")
def p1_inputs():
    """A packed bf16 block [x | cond | mask | eps] with mask 1, params, and
    sol's bf16 weights, in both packages."""
    rng = np.random.default_rng(0)
    packed = rng.normal(0, 3, (N, 41)).astype(np.float32)
    packed[:, 32] = 1.0
    w_in = rng.normal(0, 1 / np.sqrt(41), (41, 128)).astype(np.float32)
    w_ch = rng.normal(0, 1 / np.sqrt(128), (128, 128)).astype(np.float32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    jp, tp = _params(0)
    return (jb(packed), tuple(jp), jb(w_in), jb(w_ch)), (tb(packed), tp, tb(w_in), tb(w_ch))


# ---- _forward_loss -------------------------------------------------------------

def _forward_loss_f32_reference(plist, x_flat, cond, eps, cfg, w, mask=None, n_valid=None):
    """The float32 ``_forward_loss`` of the port as K1's plain version ran
    it before the ``f32_acts`` mode was added, line for line."""
    p = {n: (plist[2 * i], plist[2 * i + 1]) for i, n in enumerate(tft._LAYERS)}

    def lin(name, h):
        return h @ p[name][0] + p[name][1]

    hc = torch.relu(lin("cond_1", torch.relu(lin("cond_0", cond))))
    h = x_flat
    for name in ("enc_0", "enc_1", "enc_2", "enc_3"):
        h = torch.relu(lin(name, h))
    hcat = torch.cat([h, hc], dim=1)
    mu = lin("fc_mu", hcat)
    logvar = lin("fc_logvar", hcat)
    z = mu + eps * torch.exp(0.5 * logvar)
    g = torch.cat([z, hc], dim=1)
    for name in ("dec_0", "dec_1", "dec_2"):
        g = torch.relu(lin(name, g))
    recon = lin("dec_3", g)
    T, D = cfg.seq_len, cfg.dim
    m_col = mask if mask.ndim == 2 else mask[:, None]
    denom = (torch.clamp(torch.sum(m_col), min=1.0) if n_valid is None
             else torch.tensor(float(n_valid), device=x_flat.device))

    def mean_rows(arr):
        return torch.sum(arr * m_col) / (denom * arr.shape[1])

    recon_loss = mean_rows((recon - x_flat) ** 2)
    kld = -0.5 * mean_rows(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    start_loss = mean_rows((recon[:, 1:3] - x_flat[:, 1:3]) ** 2)
    t_diffs = recon[:, D::D] - recon[:, 0:T * D - D:D]
    time_loss = mean_rows(recon[:, 0:1] ** 2) + mean_rows(torch.relu(-t_diffs))
    total = (w.recon * recon_loss + w.kld * kld + w.start * start_loss + w.time * time_loss)
    return total, torch.stack([total, recon_loss, kld, start_loss, time_loss])


@pytest.mark.parametrize("n_valid", [None, 40.0])
def test_forward_loss_f32_path_is_unchanged(n_valid):
    """The float32 path, values and gradients, bit for bit what it was."""
    rng = np.random.default_rng(1)
    x, c, e = (torch.tensor(rng.normal(0, 3, s).astype(np.float32))
               for s in ((24, 30), (24, 2), (24, 8)))
    m = torch.ones(24, 1)
    m[-4:] = 0
    _, tp = _params(2)
    outs = []
    for fn in (_forward_loss_f32_reference, tft._forward_loss):
        ps = [a.clone().requires_grad_(True) for a in tp]
        total, comps = fn(ps, x, c, e, CFG, LW, m, n_valid)
        outs.append((comps.detach(), torch.autograd.grad(total, ps)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# ---- manual_value_and_grad's levers --------------------------------------------

LEVERS = [{}, {"chain_cd": True}, {"bias_via_dot": True}, {"grads_mode": "nodw"},
          {"grads_mode": "none"}]


@pytest.mark.parametrize("cd,lever", [
    (cd, lv) for cd in (None, "bfloat16") for lv in LEVERS
    if cd is not None or not lv.get("chain_cd")  # test_chain_cd_refuses_float32
], ids=lambda v: v if isinstance(v, str) or v is None
    else "-".join(map(str, v.values())) or "default")
def test_manual_levers_match_jax(cd, lever):
    rng = np.random.default_rng(4)
    B = 24
    x, c, e = (rng.normal(0, 3, s).astype(np.float32) for s in ((B, 30), (B, 2), (B, 8)))
    m = np.ones((B, 1), np.float32)
    m[-3:] = 0
    jp, tp = _params(1)
    jc, jg = _j_manual(jp, jnp.asarray(x), jnp.asarray(c), jnp.asarray(e), JCVAEConfig(),
                       JLossWeights(), jnp.asarray(m), n_valid=40.0,
                       compute_dtype=None if cd is None else jnp.bfloat16, **lever)
    tc, tg = manual_value_and_grad(tp, torch.tensor(x), torch.tensor(c), torch.tensor(e),
                                   CFG, LW, torch.tensor(m), n_valid=40.0,
                                   compute_dtype=cd, **lever)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    tol = 1e-5 if cd is None else 1e-2
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.numpy()).max() <= tol * max(np.abs(a).max(), 1e-30)
    if lever.get("grads_mode") == "none":
        assert all(not g.any() for g in tg)
    if lever.get("grads_mode") == "nodw":
        nz = [i for i, g in enumerate(tg) if g.any()]
        assert nz == [1] and torch.unique(tg[1]).numel() == 1  # cond_0's bias


def test_levers_change_the_gradients():
    """chain_cd and bf16 bias_via_dot round where the default does not, so
    their gradients move off the default's (by more than float32 noise)."""
    rng = np.random.default_rng(4)
    x, c, e = (torch.tensor(rng.normal(0, 3, s).astype(np.float32))
               for s in ((24, 30), (24, 2), (24, 8)))
    _, tp = _params(1)
    _, g0 = manual_value_and_grad(tp, x, c, e, CFG, LW, compute_dtype="bfloat16")
    for lever in ({"chain_cd": True}, {"bias_via_dot": True}):
        _, g1 = manual_value_and_grad(tp, x, c, e, CFG, LW, compute_dtype="bfloat16", **lever)
        gap = max(float((a - b).abs().max() / a.abs().max()) for a, b in zip(g0, g1))
        assert gap > 1e-5, lever


def test_chain_cd_refuses_float32():
    rng = np.random.default_rng(0)
    x, c, e = (rng.normal(size=s).astype(np.float32) for s in ((4, 30), (4, 2), (4, 8)))
    jp, tp = _params(0)
    with pytest.raises(ValueError, match="chain_cd requires a compute dtype") as jerr:
        j_manual(jp, jnp.asarray(x), jnp.asarray(c), jnp.asarray(e), JCVAEConfig(),
                 JLossWeights(), chain_cd=True)
    with pytest.raises(ValueError) as terr:
        manual_value_and_grad(tp, torch.tensor(x), torch.tensor(c), torch.tensor(e), CFG, LW,
                              chain_cd=True)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="grads_mode"):
        manual_value_and_grad(tp, torch.tensor(x), torch.tensor(c), torch.tensor(e),
                              CFG, LW, grads_mode="some")


# ---- K3's knobs ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def knob_inputs():
    w = _corpus(N)
    eps = np.random.default_rng(8).standard_normal((N, 8)).astype(np.float32)
    jp, tp = _params(1)
    x, s = jft.fused_inputs(w)
    return w, eps, jp, tp, jfs._pack_corpus(x, s, jnp.ones((N,)), jnp.asarray(eps), 8)


@pytest.mark.parametrize("cd,knob", [("bfloat16", k) for k in KNOBS]
                         + [(None, k) for k in ("noacc", "biasdot", "nodw")])
def test_plain_k3_knob_matches_jax(knob_inputs, cd, knob):
    """K3's plain version under each knob against JAX's K3 in interpret
    mode (manual backward, packed ε), 3 epochs."""
    w, eps, jp, tp, jpacked = knob_inputs
    jcd = None if cd is None else jnp.bfloat16
    if jcd is not None:
        jpacked = jpacked.astype(jcd)
    jo, jm = jfs._fused_scale_call(tuple(jp), jpacked, jnp.array([[3]], jnp.int32),
                                   JCVAEConfig(), JLossWeights(), 3, 1e-3, TILE, float(N),
                                   jcd, "f32_acts", "packed", interpret=True,
                                   backward="manual", _ablate=(knob,))
    nv, packed = tfs._scale_inputs(w, CFG, TILE, cd, eps, "cpu")
    before = tfs._fused_scale_call.launches
    to, tm = tfs._fused_scale_call(tp, packed, 3, CFG, LW, 3, 1e-3, TILE, float(nv), cd,
                                   "packed", _ablate=(knob,))
    assert tfs._fused_scale_call.launches == before  # the plain version, no launch
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm[:, :5].numpy(), np.asarray(jm)[:3, :5], rtol=1e-5)
    if knob in ("noadam", "fwdonly"):
        assert all(torch.equal(a, b) for a, b in zip(to, tp))


def test_noacc_takes_the_last_tile():
    """Under noacc one epoch's gradient is the last tile's alone, while the
    loss row still sums every tile."""
    w = _corpus(48)
    eps = np.random.default_rng(2).standard_normal((48, 8)).astype(np.float32)
    nv, packed = tfs._scale_inputs(w, CFG, 16, None, eps, "cpu")
    _, tp = _params(3)
    src = tfs._eps_source("packed", CFG, 16, 48, None, 0, "cpu")
    g_all, r_all = tfs._plain_grad_epoch(tp, packed, 16, CFG, LW, float(nv), None, src)
    g_last, r_last = tfs._plain_grad_epoch(tp, packed, 16, CFG, LW, float(nv), None, src,
                                           ("noacc",))
    g_tile, _ = tfs._plain_grad_epoch(tp, packed[32:], 16, CFG, LW, float(nv), None, src)
    assert torch.equal(r_all, r_last)
    assert all(torch.equal(a, b) for a, b in zip(g_last, g_tile))
    assert not all(torch.equal(a, b) for a, b in zip(g_last, g_all))


def test_knob_refusals():
    packed = torch.zeros((32, 41))
    args = ([], packed, 0, CFG, LW, 1, 1e-3, 16, 32.0)
    with pytest.raises(ValueError, match="_ablate knobs apply"):
        tfs._fused_scale_call(*args, None, "packed", _ablate=("dwT",), backward="auto")
    with pytest.raises(ValueError, match="unknown _ablate"):
        tfs._fused_scale_call(*args, None, "packed", _ablate=("nothing",))
    with pytest.raises(ValueError, match="chain_cd requires"):
        tfs._fused_scale_call(*args, None, "packed", _ablate=("chaincd",))
    assert tfs._check_ablate((), "bfloat16") == 0
    assert tfs._check_ablate(KNOBS, "bfloat16") == 127
    # what the CUDA kernel takes: one per-tile knob (besides noadam), bf16,
    # noacc on tiles of whole 32-row steps
    tfs._check_kernel_knobs(tfs._check_ablate(("noadam", "nodw"), "bfloat16"), "bfloat16", 64)
    with pytest.raises(NotImplementedError, match="one ablation knob"):
        tfs._check_kernel_knobs(tfs._check_ablate(("nodw", "noacc"), "bfloat16"), "bfloat16", 64)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfs._check_kernel_knobs(tfs._check_ablate(("noacc",), None), None, 64)
    with pytest.raises(ValueError, match="32-row"):
        tfs._check_kernel_knobs(tfs._check_ablate(("noacc",), "bfloat16"), "bfloat16", 48)


@pytest.mark.parametrize("rows", [40, 0])
@pytest.mark.parametrize("entry", ["k3", "k4"])
def test_corpus_not_whole_tiles_is_refused(entry, rows):
    """K3 and K4 refuse a corpus whose rows are not a positive multiple of
    the tile, on the plain path as on the kernel's: JAX's grid
    (``n_pad // tile`` tiles) would drop the rows past the last whole tile
    (8 of 40 here) without a word, and zero rows leave nothing to train
    on."""
    packed = torch.zeros((rows, 41))
    _, tp = _params(0)
    with pytest.raises(ValueError, match="not a positive multiple of tile=16"):
        if entry == "k3":
            tfs._fused_scale_call(tp, packed, 0, CFG, LW, 1, 1e-3, 16, 32.0, None, "packed")
        else:
            tfs._grad_epoch_call(tp, packed, 0, CFG, LW, 16, 32.0, None, "packed")


# ---- P1 and P2 -------------------------------------------------------------------------

def _abs_scale(mode, tpk, tp, w_in, w_ch):
    """The sum of the absolute values of the terms each P1 sum adds."""
    if mode == "stream":
        return float(tpk.float().abs().sum())
    if mode == "sol":
        return float(tsa._sol_h(tpk, w_in, w_ch, tsa.sol_chain_length(CFG)).abs().sum())
    return float(tsa._dx_plain(tpk, tp, CFG, LW, float(N)).float().abs().sum())


@pytest.mark.parametrize("mode", ["stream", "sol", "fwd", "dx"])
def test_p1_plain_matches_jax(jax_ablation, p1_inputs, mode):
    """P1's plain versions against the JAX script's ``_ablation_call``
    (interpret mode) on the same packed bf16 block and params."""
    (jpk, jp, jw_in, jw_ch), (tpk, tp, tw_in, tw_ch) = p1_inputs
    n_chain = tsa.sol_chain_length(CFG)
    plist = {"stream": (), "sol": (jw_in, jw_ch)}.get(mode, jp)
    j = np.asarray(jax_ablation._ablation_call(
        jpk, plist, mode, JCVAEConfig(), JLossWeights(), float(N), jnp.bfloat16,
        n_chain=n_chain if mode == "sol" else 0))[:EPOCHS]
    if mode == "stream":
        t = tsa.p1_stream(tpk, EPOCHS, TILE)
    elif mode == "sol":
        t = tsa.p1_sol(tpk, tw_in, tw_ch, n_chain, EPOCHS, TILE)
    else:
        t = tsa.p1_ablation(tpk, tp, mode, CFG, LW, float(N), EPOCHS, TILE)
    t = t.numpy()
    assert t.shape == (EPOCHS, 8)
    if mode in ("fwd", "dx"):
        np.testing.assert_allclose(t[:, :5], j[:, :5], rtol=1e-5)
    col = {"stream": 0, "sol": 0, "fwd": None, "dx": 5}[mode]
    if col is not None:
        scale = _abs_scale(mode, tpk, tp, tw_in, tw_ch)
        assert np.abs(t[:, col] - j[:, col]).max() <= 1e-5 * scale
        assert np.all(t[:, col] == t[0, col])  # every epoch the same sum
    assert not np.any(t[:, 6:])


def test_sol_chain_length_is_jaxs():
    """23 products: 764,160 FLOP a window-epoch against K3's 766,464."""
    n = tsa.sol_chain_length(CFG)
    sum_fifo = sum(fi * fo for fi, fo in CFG.layer_spec().values())
    assert n == 23
    assert 2 * 41 * 128 + n * 2 * 128 * 128 == 764160 and 6 * sum_fifo == 766464


def _jax_probe_kernel():
    """``_stream_kernel`` of the JAX probe, taken from its source: importing
    the script would re-execute the process (its module-level cache setup)."""
    path = REPO_ROOT / "scripts" / "noise_consumer_probe.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_stream_kernel")
    ns = {"jnp": jnp}
    exec(compile(ast.Module([fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["_stream_kernel"]


@pytest.mark.parametrize("rows", [2048, 6144])
def test_p2_plain_matches_jax(rows):
    """P2's plain version against the JAX probe's kernel in a
    ``pallas_call(..., interpret=True)`` at a small ROWS, tile 2048."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    eps = np.random.default_rng(rows).standard_normal((rows, 8)).astype(np.float32)
    je = jnp.asarray(eps).astype(jnp.bfloat16)
    j = pl.pallas_call(
        _jax_probe_kernel(), grid=(rows // 2048,),
        out_shape=jax.ShapeDtypeStruct((1, 8), jnp.float32),
        in_specs=[pl.BlockSpec((2048, 8), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8), lambda i: (0, 0), memory_space=pltpu.VMEM),
        interpret=True)(je)
    te = torch.tensor(eps).to(torch.bfloat16)
    before = tsa.p2_stream_sum.launches
    t = tsa.p2_stream_sum(te, 2048)
    assert tsa.p2_stream_sum.launches == before
    assert t.shape == (1, 8) and torch.all(t == t[0, 0])
    scale = float(te.float().abs().sum())
    assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-5 * scale


def test_p2_on_the_cpu_builds_and_loads_nothing(monkeypatch):
    """On CPU tensors P2 runs its plain version: no build (there is no nvcc
    here), no library, no workspace."""
    from defensive_model_vae_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_start_build", refuse)
    loaded = dict(_build._LOADED)
    eps = torch.ones((4096, 8), dtype=torch.bfloat16)
    assert torch.equal(tsa.p2_stream_sum(eps, 2048), torch.full((1, 8), 4096.0 * 8))
    assert _build._LOADED == loaded and not tsa._P2_WS


def test_p2_limit_catches_a_dropped_batch_or_block():
    """chip_smoke.py's P2 check on a small N(0, 1) stream (128 batches over
    16 blocks): the blocks' shares add up to the stream's sum, the plain
    float32 sum lies within P2_TOL of Σ|terms| of the float64 sum, and each
    wrong plain version (a batch or a block left out) lies outside it."""
    import chip_smoke

    eps = torch.randn((2048 * 64, 8), generator=torch.Generator().manual_seed(3))
    eps = eps.to(torch.bfloat16)
    exact = float(eps.double().sum())
    plain = float(tsa._p2_plain(eps, 2048)[0, 0])
    tol = chip_smoke.P2_TOL * float(eps.double().abs().sum())
    wrong, shares = chip_smoke.p2_wrong_sums(eps, 16, plain)
    assert shares.shape == (16,) and abs(float(shares.sum()) - exact) <= 1e-6 * tol
    assert abs(plain - exact) <= tol
    assert set(wrong) == {"last_batch_dropped", "median_block_dropped"}
    assert all(abs(v - plain) > tol for v in wrong.values())
    assert abs(wrong["last_batch_dropped"] - plain) == pytest.approx(
        abs(float(eps[-1024:].double().sum())))


def test_p1_stream_ab_needs_the_card():
    """The A/B timer of two checkouts' P1-stream builds runs on the card
    only; here it refuses before it builds anything."""
    from defensive_model_vae_tpu_torch.scripts import p1_stream_ab

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p1_stream_ab.main(["--a", str(REPO_ROOT)])


def test_p1_p2_refusals():
    with pytest.raises(ValueError, match="bf16"):
        tsa.p1_stream(torch.zeros((32, 41)), 1, 16)
    with pytest.raises(ValueError, match="multiple of tile"):
        tsa.p1_stream(torch.zeros((40, 41), dtype=torch.bfloat16), 1, 16)
    with pytest.raises(ValueError, match="packed-ε columns"):
        tsa.p1_ablation(torch.zeros((32, 33), dtype=torch.bfloat16), [], "fwd", CFG, LW,
                        32.0, 1, 16)
    with pytest.raises(ValueError, match="mode"):
        tsa.p1_ablation(torch.zeros((32, 41), dtype=torch.bfloat16), [], "bwd", CFG, LW,
                        32.0, 1, 16)
    with pytest.raises(ValueError, match="w_in"):
        tsa.p1_sol(torch.zeros((32, 41), dtype=torch.bfloat16), torch.zeros((41, 128)),
                   torch.zeros((128, 128)), 2, 1, 16)
    with pytest.raises(ValueError, match="CUDA or"):
        tsa.p2_stream_sum(torch.zeros((2048, 8), dtype=torch.bfloat16, device="meta"))


# ---- the ported scripts -----------------------------------------------------------------

def test_scale_ablation_smoke():
    """The ported script's ``--smoke`` on the CPU passes JAX's smoke asserts."""
    assert scale_ablation.main(["--smoke"]) == 0


def test_scale_ablation_breakdown(capsys):
    """A tiny CPU run prints one JSON line with every variant and bucket
    (the autodiff ones among them), and writes only --out."""
    import json

    assert scale_ablation.main(["--n", "4096", "--epochs", "1", "--tile", "1024", "--reps",
                                "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])["scale_ablation"]
    assert set(out["variants"]) == set(scale_ablation.VARIANTS)
    assert set(out["breakdown_s"]) == {
        "manual_backward_saves", "prng", "prng_manual", "hbm_stream_overhead_vs_packed",
        "adam", "acc_read_add", "biasdot_saves", "chaincd_saves", "dwT_saves", "manual_dw",
        "manual_dy_chain", "manual_fwd_floor", "dw_acc_adam", "dy_chain",
        "fwd_overhead_vs_sol", "sol_vs_stream", "stream_floor"}
    assert {"full", "full_eps", "hbm_dwT"} <= set(out["variants"])
    assert "not_ported" not in out
    assert out["device"] == "cpu" and out["sol_chain"] == 23


def test_noise_consumer_probe_smoke(capsys, tmp_path):
    import json

    path = tmp_path / "probe.json"
    assert noise_consumer_probe.main(["--smoke", "--out", str(path)]) == 0
    out = json.loads(capsys.readouterr().out.strip())["noise_consumer_probe"]
    assert set(out["variants"]) == {"sum", "stream"} and "collapsed" in out["impl_axis"]
    assert json.loads(path.read_text()) == out


@pytest.mark.parametrize("entry", [scale_ablation.main, noise_consumer_probe.main])
def test_scripts_refuse_without_cuda(entry):
    """No GPU and no --device cpu: the entry points raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(["--epochs", "1", "--n", "2048"])


def test_k3_digest_runs_on_the_cpu_and_refuses_without_cuda(capsys):
    """The digest script hashes each case's result (the plain versions' on
    the CPU, for which it holds no reference) and, with no GPU and no
    --device cpu, raises."""
    import json

    assert k3_digest.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert set(out["k3_digest"]) == set(k3_digest.CASES)
    assert all(len(d) == 64 for d in out["k3_digest"].values())
    assert out["sms"] is None and out["reference"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            k3_digest.main([])


def test_ablation_modules_run_with_jax_blocked(tmp_path):
    """The new modules import and run with jax and the JAX package blocked."""
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "optax", "pandas", "matplotlib",
                     "defensive_model_vae_tpu"):
            sys.modules[name] = None
        from defensive_model_vae_tpu_torch.ops import fused_scale, scale_ablation
        from defensive_model_vae_tpu_torch.scripts import (
            k3_digest, noise_consumer_probe, scale_ablation as script)
        assert script.main(["--smoke"]) == 0
        assert noise_consumer_probe.main(["--smoke"]) == 0
        print("BLOCKED_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BLOCKED_OK" in out.stdout
