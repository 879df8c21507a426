"""The K3 ablation's kernels on the card, against their plain versions: K3
under each ``_ablate`` knob, P1 (stream, sol, fwd, dx) and P2.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package, so they also run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_ablation_card.py -q

Tolerances, as in chip_smoke.py: K3 under a knob, one epoch, as K3 itself
(``K3_TOL``'s bf16 one-epoch row: params atol 1e-5, metrics rtol 1e-5),
and its summed gradients (read from the noadam sink) to 1e-2 of each
array's max, K4's bf16 rule.  noacc's step reads one tile's gradient sum,
in which more elements sit at bf16 rounding level, and such an element can
step the other way: its params are held to one step's travel the other way
(2·lr) on at most 5% of elements (chip_smoke.py's ``NOACC_TOL``).  The
corpus is 8,448 rows in tiles of 352, so a block runs two 32-row steps and
one block's chunk straddles the start of the last tile, which is the case
noacc's design has to get right.  P1 and P2: each sum within a fraction of
the sum of the absolute values of its terms, 1e-5 for the plain sums
(P1-stream, P2) and 1e-6 for P1-sol's and dx's, which lies below the gaps
of plain versions with one deliberate error (chip_smoke.py's ``P1_TOL``);
the loss components rtol 1e-5.  K3 with ``_ablate=()`` and K4 are held bit
for bit to their reference digests (``scripts/k3_digest.py``: float32 the
build before the tensor cores, bf16 the tensor-core engine's).
"""

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft
from defensive_model_vae_tpu_torch.ops import scale_ablation as sa
from defensive_model_vae_tpu_torch.scripts import k3_digest
from defensive_model_vae_tpu_torch.scripts.scale_ablation import scale_corpus

pytestmark = pytest.mark.gpu

CFG, LW = CVAEConfig(), LossWeights()
N, TILE = 8448, 352


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev):
    eps = np.random.default_rng(1).standard_normal((N, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(scale_corpus(N, seed=3), CFG, TILE, "bfloat16", eps, dev)
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, dev))
    return plist, packed, float(nv)


@pytest.mark.parametrize("knob", ["noadam", "noacc", "biasdot", "chaincd", "nodw", "fwdonly"])
def test_k3_knob_matches_plain(knob):
    dev = _cuda()
    plist, packed, nv = _inputs(dev)
    args = (plist, packed, 3, CFG, LW, 1, 1e-3, TILE, nv, "bfloat16", "packed", None)
    before = fs._fused_scale_call.launches
    pk, mk = fs._fused_scale_call(*args, _ablate=(knob,))
    pp, mp = fs._fused_scale_call_plain(*args, _ablate=(knob,))
    torch.cuda.synchronize()
    assert fs._fused_scale_call.launches == before + 1
    for a, b in zip(pk, pp):
        gap = (a - b).abs()
        if knob == "noacc":
            assert float(gap.max()) <= 2e-3 + 1e-5 and float((gap > 1e-4).float().mean()) <= 0.05
        else:
            assert float(gap.max()) <= 1e-5
    assert torch.allclose(mk[:, :5], mp[:, :5], rtol=1e-5, atol=0)
    if knob in ("noadam", "fwdonly"):
        assert all(torch.equal(a, b) for a, b in zip(pk, plist))
    # the epoch's summed gradients, from the noadam sink
    sink = torch.empty(ft.pack_kernel_params(plist).numel(), device=dev)
    fs._fused_scale_call_kernel(*args, fs._check_ablate(("noadam", knob), "bfloat16"), sink)
    src = fs._eps_source("packed", CFG, TILE, N, None, 3, dev)
    gp, _ = fs._plain_grad_epoch(plist, packed, TILE, CFG, LW, nv, "bfloat16", src, (knob,))
    for a, b in zip(ft.unpack_kernel_params(sink, plist), gp):
        assert float((a - b).abs().max()) <= 1e-2 * max(float(b.abs().max()), 1e-30)


def test_k3_without_knobs_is_the_default_call():
    """K3 with ``_ablate=()`` (and K4) bit for bit their reference digests:
    the default call's engine."""
    dev = _cuda()
    ref = k3_digest.REFERENCE.get(k3_digest.sm_count(dev))
    assert ref is not None, "no reference digests for this card's SM count"
    assert k3_digest.digests(dev, _ablate=()) == ref


@pytest.mark.parametrize("mode", ["stream", "sol", "fwd", "dx"])
def test_p1_matches_plain(mode):
    dev = _cuda()
    plist, packed, nv = _inputs(dev)
    g = torch.Generator().manual_seed(5)
    w_in = (torch.randn((41, 128), generator=g) / 41 ** 0.5).to(torch.bfloat16).to(dev)
    w_ch = (torch.randn((128, 128), generator=g) / 128 ** 0.5).to(torch.bfloat16).to(dev)
    n_chain = sa.sol_chain_length(CFG)
    if mode == "stream":
        k, p = sa.p1_stream(packed, 2, TILE), sa._p1_stream_plain(packed, 2, TILE)
        scale = float(packed.float().abs().sum())
    elif mode == "sol":
        k = sa.p1_sol(packed, w_in, w_ch, n_chain, 2, TILE)
        p = sa._p1_sol_plain(packed, w_in, w_ch, n_chain, 2, TILE)
        scale = float(sa._sol_h(packed, w_in, w_ch, n_chain).abs().sum())
    else:
        k = sa.p1_ablation(packed, plist, mode, CFG, LW, nv, 2, TILE)
        p = sa._p1_ablation_plain(packed, plist, mode, CFG, LW, nv, 2)
        scale = float(sa._dx_plain(packed, plist, CFG, LW, nv).float().abs().sum())
    torch.cuda.synchronize()
    if mode in ("fwd", "dx"):
        assert torch.allclose(k[:, :5], p[:, :5], rtol=1e-5, atol=0)
    col = 5 if mode == "dx" else 0
    if mode != "fwd":
        # chip_smoke.py's P1_TOL: float32 sums in another order (stream);
        # below the plain versions with one deliberate error (sol, dx)
        tol = 1e-5 if mode == "stream" else 1e-6
        assert float((k[:, col] - p[:, col]).abs().max()) <= tol * scale
    assert torch.equal(k[0], k[1])  # every epoch the same row


def test_p2_matches_plain():
    dev = _cuda()
    eps = fs.hbm_noise(5, 4, 131072, 8, "bfloat16", dev)
    before = sa.p2_stream_sum.launches
    k = sa.p2_stream_sum(eps, 2048)
    p = sa._p2_plain(eps, 2048)
    torch.cuda.synchronize()
    assert sa.p2_stream_sum.launches == before + 1
    assert torch.all(k == k[0, 0])
    assert float((k - p).abs().max()) <= 1e-5 * float(eps.float().abs().sum())


def test_p2_same_bits_on_every_call():
    dev = _cuda()
    eps = fs.hbm_noise(7, 4, 131072, 8, "bfloat16", dev)
    a, b, c = (sa.p2_stream_sum(eps, 2048) for _ in range(3))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(b, c)


def test_p2_ones_sum_exactly():
    """Every partial of a stream of ones is an integer under 2**24, so the
    float32 sum is exact whatever its order: rows * 8."""
    dev = _cuda()
    rows = 2048 * 1000
    got = sa.p2_stream_sum(torch.ones((rows, 8), dtype=torch.bfloat16, device=dev), 2048)
    torch.cuda.synchronize()
    assert rows * 8 <= 2 ** 24
    assert torch.equal(got.cpu(), torch.full((1, 8), float(rows * 8)))


@pytest.mark.parametrize("case", ["batch_tail", "unaligned"])
def test_p2_tails_match_plain(case):
    """A stream that ends inside one thread's batch of P2_U loads (16,000
    vectors: 15 batches of 1,024 and 640), and one whose base lies 6 bytes
    past a 16-byte boundary (3 columns, one row dropped: a scalar head and
    tail around the vectors)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(11)
    if case == "batch_tail":
        eps, tile = torch.randn((16000, 8), generator=g).to(torch.bfloat16).to(dev), 16
    else:
        eps, tile = torch.randn((2049, 3), generator=g).to(torch.bfloat16).to(dev)[1:], 2048
        assert eps.is_contiguous() and eps.data_ptr() % 16 == 6
    k, p = sa.p2_stream_sum(eps, tile), sa._p2_plain(eps, tile)
    torch.cuda.synchronize()
    assert torch.all(k == k[0, 0])
    assert float((k - p).abs().max()) <= 1e-5 * float(eps.float().abs().sum())


def test_p2_one_cuda_launch_a_call():
    dev = _cuda()
    eps = fs.hbm_noise(8, 1, 131072, 8, "bfloat16", dev)
    before = sa.cuda_launches()["p2"]
    for _ in range(3):
        sa.p2_stream_sum(eps, 2048)
    torch.cuda.synchronize()
    assert sa.cuda_launches()["p2"] == before + 3


def test_p2_two_streams_in_turn():
    """Each stream has its own workspace (partials and ticket); calls on
    two streams in turn give the same bits as on the default stream."""
    dev = _cuda()
    eps = fs.hbm_noise(9, 4, 131072, 8, "bfloat16", dev)
    want = sa.p2_stream_sum(eps, 2048)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = []
    for s in streams + streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(sa.p2_stream_sum(eps, 2048))
    torch.cuda.synchronize()
    assert all(torch.equal(r, want) for r in got)
    assert {(eps.device.index, s.cuda_stream) for s in streams} <= set(sa._P2_WS)
