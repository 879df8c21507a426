"""P3 (the cache probe's decoy) on the card, against its plain version.

These tests need a CUDA card and skip without one.  They import neither
jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_probe_card.py -q

The kernel computes ``x * 2 + 1`` with one rounding (2x is exact), so it
is held to its plain version bit for bit: on its (128, 128) shape (one
float4 a thread), on a size that is not a multiple of 4 (the scalar tail),
on a contiguous slice that starts 4 bytes past an aligned base (the
scalar path), and through a CUDA graph, whose capture also shows that the
kernel launches on PyTorch's current stream.
"""

import pytest
import torch

from defensive_model_vae_tpu_torch.ops import cache_decoy

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _x(n, seed):
    return torch.randn(n, generator=torch.Generator().manual_seed(seed)) * 1e3


@pytest.mark.parametrize("case", ["shape", "odd", "offset"])
def test_p3_bit_for_bit(case):
    dev = _cuda()
    if case == "shape":
        x = _x(cache_decoy.SHAPE[0] * cache_decoy.SHAPE[1], 1).reshape(cache_decoy.SHAPE)
        xd = x.to(dev)
    elif case == "odd":
        x = _x(16_387, 2)
        xd = x.to(dev)
    else:
        base = _x(16_385, 3).to(dev)
        xd = base[1:]  # contiguous, 4 bytes past a 16-byte boundary
        x = xd.cpu()
        assert xd.is_contiguous() and xd.data_ptr() % 16 == 4
    before = cache_decoy.decoy.launches
    got = cache_decoy.decoy(xd)
    torch.cuda.synchronize()
    assert cache_decoy.decoy.launches == before + 1
    assert got.shape == x.shape and torch.equal(got.cpu(), cache_decoy._decoy_plain(x))


def test_p3_graph_capture_and_replay():
    dev = _cuda()
    x = _x(cache_decoy.SHAPE[0] * cache_decoy.SHAPE[1], 4).reshape(cache_decoy.SHAPE).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cache_decoy.decoy(x)  # bound and warm before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cache_decoy.decoy(x)
    for seed in (5, 6):
        new = _x(x.numel(), seed).reshape(cache_decoy.SHAPE)
        x.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y.cpu(), cache_decoy._decoy_plain(new))
