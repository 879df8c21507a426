"""The host side of K3's and K4's product engine, on the CPU.

The engine (``csrc/scale_common.cuh``) stages the bf16 modes' forward
weights from a bf16 copy of the params and defers their weight gradients
to the end of each chunk, through a scratch of their bf16 operands, onto
the tensor cores.  What the wrappers compute around it is held here:
the C entries' arguments, the bf16 copy's rounding, the chunk and scratch
layout, and the refusals, among them a library without the tensor-core
engine (no fallback to another path).  The kernels themselves run on the
card (``tests/test_torch_scale_card.py``).
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import _build
from defensive_model_vae_tpu_torch.ops import fused_scale as fs
from defensive_model_vae_tpu_torch.ops import fused_trainer as ft

CFG = CVAEConfig()
_P = ctypes.c_void_p


def _entry(name):
    return _build.KERNELS["fused_scale"][1][name]


def test_k3_entry_takes_the_bf16_copy_and_scratch_before_the_knobs():
    restype, args = _entry("k3_train")
    assert restype is ctypes.c_int
    # corpus, width, eps, dtype, noise, n_pad, tile | n_valid, epochs, lr,
    # 4 weights, seed, params, m|v, partials, SMs, metrics | pb, scratch,
    # ablate, sink, stream
    assert len(args) == 7 + 13 + 5
    assert args[20:] == [_P, _P, ctypes.c_int, _P, _P]
    assert args[15:20] == [_P, _P, _P, ctypes.c_int, _P]


@pytest.mark.parametrize("name", ["k4_grad_epoch", "k4_grad_epoch_auto"])
def test_k4_entries_take_the_bf16_copy_and_scratch_before_the_stream(name):
    restype, args = _entry(name)
    assert restype is ctypes.c_int
    assert len(args) == 7 + 5 + 1 + 3 + 2 + 2 + 1
    assert args[-5:] == [_P, _P, _P, _P, _P]  # grad, row, pb, scratch, stream
    assert args[-8:-5] == [_P, _P, ctypes.c_int]  # params, partials, SMs


def test_k3_auto_entry_takes_the_bf16_copy_and_scratch_before_the_stream():
    _, args = _entry("k3_train_auto")
    assert len(args) == 7 + 13 + 3
    assert args[-3:] == [_P, _P, _P]  # pb, scratch, stream
    assert args[-4] is _P  # metrics


@pytest.mark.parametrize("name,restype,args", [
    ("ks_engine", ctypes.c_int, []),
    ("ks_weights_bf16", ctypes.c_int, [_P, _P, _P]),
    ("ks_scratch_elems", ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int]),
    ("ks_scratch_elems_auto", ctypes.c_longlong,
     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]),
])
def test_engine_entries_are_registered(name, restype, args):
    assert _entry(name) == (restype, args)


def _rne_bf16_bits(x: np.ndarray) -> np.ndarray:
    """bf16 bits of float32 x by round-to-nearest-even on the bit pattern."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def test_bf16_weight_copy_rounds_to_nearest_even():
    ones = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 2.0 ** -126, 0.0, -0.0]
    got = fs.weights_bf16(torch.tensor(ones)).float().tolist()
    assert got[:3] == [1.0, 1.0 + 2.0 ** -6, -1.0]  # the ties go to the even mantissa
    assert got[3:] == [2.0 ** -126, 0.0, -0.0]
    assert str(fs.weights_bf16(torch.tensor([-0.0])).float().item()) == "-0.0"


def test_bf16_weight_copy_of_the_params_matches_bitwise_rne():
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(3), CFG, "cpu"))
    flat = ft.pack_kernel_params(plist)
    copy = fs.weights_bf16(flat)
    assert copy.dtype == torch.bfloat16 and copy.shape == flat.shape
    assert torch.equal(copy, flat.to(torch.bfloat16))
    bits = copy.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits, _rne_bf16_bits(flat.numpy()))


def test_kernel_layers_are_the_flat_parameter_layout():
    assert sum(fi * fo + fo for fi, fo in fs._KERNEL_LAYERS) == 128942
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, "cpu"))
    assert ft.pack_kernel_params(plist).numel() == 128942
    fan = [(fi, fo) for fi, fo in fs._KERNEL_LAYERS]
    assert fan[6] == (2 * CFG.hidden_dim, 2 * CFG.latent_dim)   # merged mu|logvar head
    assert fan[7] == (CFG.latent_dim + CFG.hidden_dim, CFG.hidden_dim)


def test_scratch_row_pads_each_operand_to_sixteen_bytes():
    row = fs.scratch_row()
    assert row == 2528 and row % 8 == 0
    # inputs 1320 and cotangents 1198 values a row, before the padding
    assert sum(fi for fi, _ in fs._KERNEL_LAYERS) == 1320
    assert sum(fo for _, fo in fs._KERNEL_LAYERS) == 1198


@pytest.mark.parametrize("n_pad,sms,per,chunks", [
    (131072, 132, 32, 128),    # the bench shape: 4096 steps, 4 SMs idle
    (8448, 132, 2, 132),       # the digest cases: 264 steps
    (1024, 132, 1, 32),
    (16, 132, 1, 1),           # one step, mostly padding
    (20000, 132, 5, 125),      # a short last chunk
    (704, 3, 8, 3),
])
def test_chunk_layout(n_pad, sms, per, chunks):
    assert fs.chunk_steps(n_pad, sms) == per
    assert fs.n_chunks(n_pad, sms) == chunks
    steps = -(-n_pad // 32)
    assert (chunks - 1) * per < steps <= chunks * per  # every step in one chunk
    assert fs.scratch_elems(n_pad, sms) == chunks * per * 32 * fs.scratch_row()


def test_scratch_at_the_bench_shape():
    elems = fs.scratch_elems(131072, 132)
    assert elems == 128 * 32 * 32 * 2528
    assert 2 * elems < 700e6  # bytes, on an 80 GB card
    assert fs.scratch_elems(0, 132) == 0 and fs.scratch_elems(64, 0) == 0


def _stub_lib(engine=None):
    lib = types.SimpleNamespace()
    if engine is not None:
        lib.ks_engine = lambda: engine
    return lib


@pytest.mark.parametrize("engine", [None, 0, 2 * fs.ENGINE_TENSOR_CORES])
def test_bf16_refuses_a_library_without_the_tensor_core_engine(engine):
    with pytest.raises(RuntimeError, match="tensor-core engine"):
        fs._check_engine(_stub_lib(engine), "bfloat16")


def test_float32_needs_no_tensor_core_engine():
    fs._check_engine(_stub_lib(), None)
    fs._check_engine(_stub_lib(fs.ENGINE_TENSOR_CORES), "bfloat16")


@pytest.mark.parametrize("call", ["k3", "k3_auto", "k4"])
def test_missing_tensor_core_entry_raises_before_any_launch(monkeypatch, call):
    """The wrappers' shared checks refuse the library before they touch the
    card: nothing falls back to another engine or to the plain version."""
    monkeypatch.setattr(_build, "load", lambda name: _stub_lib())
    n, tile = 64, 32
    plist = ft._flatten_params(init_params(torch.Generator().manual_seed(0), CFG, "cpu"))
    eps = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    nv, packed = fs._scale_inputs(np.zeros((n, 10, 3), np.float32), CFG, tile, "bfloat16",
                                  eps, "cpu")
    args = (plist, packed, 0, CFG, LossWeights(), 1, 1e-3, tile, float(nv), "bfloat16",
            "packed", None)
    with pytest.raises(RuntimeError, match="tensor-core engine"):
        if call == "k3":
            fs._fused_scale_call_kernel(*args)
        elif call == "k3_auto":
            fs._fused_scale_call_auto_kernel(*args, "f32_acts")
        else:
            fs._grad_epoch_call_kernel(plist, packed, 0, CFG, LossWeights(), tile, float(nv),
                                       "bfloat16", "packed", None)
