"""Production-scale fused CVAE trainer: kernels K3 and K4 and their plain
versions.

Port of ``defensive_model_vae_tpu/ops/fused_scale.py``.  There, one Pallas
kernel (``_make_scale_kernel`` :191, launched by ``_fused_scale_call``
:310) walks the grid (epochs × tiles) in order on one core: per tile the
forward and the manual backward with the loss scaled by the GLOBAL valid-row
count, the gradients summed across tiles in VMEM scratch, Adam on the last
tile of each epoch.  A second kernel (``_make_grad_kernel`` :500, launched
by ``_grad_epoch_call`` :567) is one epoch of that without Adam, the
building block of the data-parallel trainer ``fused_train_scale_dp`` (:625).

Here both are ``csrc/fused_scale.cu``.  Hopper's blocks run in parallel and
in no order, so the cross-tile sum becomes a second pass: each epoch is one
launch of a gradient kernel, whose blocks each take a chunk of rows and
write partial gradients, then one launch that sums the partials in chunk
(and so tile) order and applies Adam (K3) or returns the sum (K4).  The
design note in that file gives the bound and the layout.

Plain parts ported as they are: ``_resolve_backward`` (:147),
``_pack_corpus`` (:169), ``_check_scale_tile`` (:797) and
``_check_eps_hbm_budget`` (:823) with their limits restated for the port,
``fused_train_scale`` (:394), ``fused_train_scale_dp`` (:625) on one
device, and the oracle ``fused_scale_reference`` (:847).

Noise (``noise=``), as in JAX:

- ``"packed"`` — an explicit (N, Z) ε held constant over the epochs, carried
  in the corpus columns (reached only through ``eps=``);
- ``"prng"`` — drawn inside the kernel: Philox4x32-10 + Box–Muller keyed by
  s = seed + e·n_tiles + i (K4: s = base + i) with counter (0, row in tile,
  column group, 0), so tile i of epoch e is ``philox_normal(s, 0, tile, Z)``;
- ``"hbm"`` (the default) — every epoch's ε drawn in advance, outside the
  kernel, into one flat (epochs·n_pad·Z) buffer by a seeded torch generator
  on the device, cast to the compute dtype and read epoch-major: step
  (e, i) reads rows e·n_pad + i·tile.  The stream is torch's, not JAX's
  ``rbg``; :func:`hbm_noise_impl` names it for the manifest.

Backward (``backward=``, resolved as JAX :147-166): ``"manual"``, the
hand-written backward of ``manual_grad`` (the default wherever it applies:
float32 and ``f32_acts``), or ``"auto"``, the arithmetic of JAX's
``jax.value_and_grad`` of ``_forward_loss`` per tile, in three modes:
float32, ``f32_acts`` and ``bf16_chain`` (which has no manual backward).
Under ``"auto"`` with a compute dtype, autodiff returns each tile's weight
gradients rounded to bf16 (and in ``bf16_chain`` its bias gradients too),
and the tiles' gradients are then summed in float32: the kernels' auto
instances cut the corpus into chunks that never straddle a tile, and
their reduce sums a tile's chunks, rounds, then adds the tiles in order.
The plain version is autograd of ``_forward_loss`` per tile.

``_fused_scale_call(..., _ablate=(...))`` takes K3's ablation knobs
(JAX :194-281), each of which removes one layer of work, for the ablation
script ``scripts/scale_ablation.py``: ``noadam`` (params, m and v never
updated), ``noacc`` (Adam takes the last tile's gradient sum only; the
metrics still sum every tile), and ``biasdot``, ``chaincd``, ``nodw``,
``fwdonly`` and ``dwT``, which are ``manual_value_and_grad``'s levers
``bias_via_dot``, ``chain_cd``, ``grads_mode="nodw"``,
``grads_mode="none"`` and ``dw_mode="transpose"``.  The knobs turn the
manual backward.  Production callers leave ``_ablate`` empty.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params
from ..models.cvae import Params
from .fused_trainer import (
    FUSED_METRIC_KEYS,
    _adam_step,
    _flatten_params,
    _forward_loss,
    _unflatten_params,
    autodiff_value_and_grad,
    fused_inputs,
    pack_kernel_params,
    philox_normal,
    unpack_kernel_params,
)
from .manual_grad import manual_value_and_grad

# the one model shape the CUDA kernels are compiled for (CVAEConfig defaults)
_KERNEL_CFG = CVAEConfig()

NOISE_MODES = {"packed": 0, "hbm": 1, "prng": 2}

# K3's ablation knobs as the bits of k3_train's ``ablate`` argument, and the
# manual-backward lever each of the per-tile ones turns (JAX :246-253)
ABLATE_BITS = {"noadam": 1, "noacc": 2, "biasdot": 4, "chaincd": 8, "nodw": 16,
               "fwdonly": 32, "dwT": 64}
_KNOB_LEVERS = {"biasdot": ("bias_via_dot", True), "chaincd": ("chain_cd", True),
                "fwdonly": ("grads_mode", "none"), "nodw": ("grads_mode", "nodw"),
                "dwT": ("dw_mode", "transpose")}

# the dtype modes of the autodiff instances (k3_train_auto's ``mode``)
AUTO_MODES = {"float32": 0, "f32_acts": 1, "bf16_chain": 2}

# Guards, restated for an 80 GB H100 and this port:
# - the tile is the unit of the noise stream (prng keys, hbm row blocks)
#   and of the plain version's working set; the CUDA kernels stream 32-row
#   steps whatever the tile, so only the plain version is bounded by it:
#   about 25 KB a row of float32 activations, cotangents and temporaries,
#   held under 1 GiB;
# - the hbm buffer is drawn in float32 by torch's generator and then cast,
#   so the peak is (4 + itemsize) B an element; 16 GiB leaves most of the
#   card to the corpus, the partial gradients and the plain version.
_TILE_BYTES_PER_ROW = 25 * 1024
_TILE_LIMIT_BYTES = 1 << 30
_EPS_HBM_LIMIT_BYTES = 16 << 30


def _resolve_backward(backward, compute_dtype, mixed_style):
    """None means the hand-written backward wherever it applies (float32 and
    ``f32_acts``) and autodiff's arithmetic for ``bf16_chain``, whose
    whole-chain roundings are the autodiff structure the manual backward
    replaces (JAX :147-166)."""
    manual_ok = compute_dtype is None or mixed_style == "f32_acts"
    if backward is None:
        return "manual" if manual_ok else "auto"
    if backward not in ("auto", "manual"):
        raise ValueError(f"backward must be 'auto' or 'manual' (got {backward!r})")
    if backward == "manual" and not manual_ok:
        raise ValueError("backward='manual' supports compute_dtype=None or the "
                         "'f32_acts' mixed style (bf16_chain keeps the autodiff path)")
    return backward


def _auto_mode(compute_dtype, mixed_style) -> str:
    """The autodiff instance's dtype mode: float32, f32_acts or bf16_chain."""
    return "float32" if compute_dtype is None else mixed_style


def _check_scale_args(windows, tile, compute_dtype, mixed_style, eps, noise,
                      backward):
    """The argument checks both trainers share, in JAX's order → (cfg, the
    noise mode: 'packed' exactly when an explicit ε is given, the resolved
    backward)."""
    if mixed_style not in ("f32_acts", "bf16_chain"):
        raise ValueError(f"mixed_style must be 'f32_acts' or 'bf16_chain' "
                         f"(got {mixed_style!r})")
    backward = _resolve_backward(backward, compute_dtype, mixed_style)
    cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    _check_scale_tile(cfg, tile, compute_dtype, mixed_style)
    if eps is not None:
        return cfg, "packed", backward
    if noise not in ("hbm", "prng"):
        raise ValueError(f"noise must be 'hbm' or 'prng' (got {noise!r})")
    return cfg, noise, backward


def _torch_dtype(compute_dtype):
    if compute_dtype is None:
        return torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or 'bfloat16' (got {compute_dtype!r})")


def _pack_corpus(x_flat, cond, mask, eps, latent_dim: int) -> torch.Tensor:
    """[x_flat | cond | mask (| eps)] as one (N, F+C+1[+Z]) tensor.  The ε
    columns exist only in the explicit-ε ('packed') mode."""
    n = x_flat.shape[0]
    cols = [x_flat, cond, mask.reshape(n, 1)]
    if eps is not None:
        if eps.shape[1] != latent_dim:
            raise ValueError(f"explicit eps has {eps.shape[1]} columns, expected "
                             f"latent_dim={latent_dim}")
        cols.append(eps)
    return torch.cat(cols, dim=1)


def _check_scale_tile(cfg: CVAEConfig, tile: int, compute_dtype,
                      mixed_style="f32_acts"):
    """Refuse tiles that are not aligned: 8 rows in float32, 16 in bf16, as
    the JAX kernel requires."""
    align = 16 if compute_dtype is not None else 8
    if tile % align != 0 or tile <= 0:
        raise ValueError(f"tile must be a positive multiple of {align} for "
                         f"compute_dtype={compute_dtype} (got {tile})")


def _check_plain_tile(tile: int):
    """Refuse a tile whose plain-version working set is over the guard above."""
    need = tile * _TILE_BYTES_PER_ROW
    if need > _TILE_LIMIT_BYTES:
        raise ValueError(f"tile={tile} needs ~{need / 2**30:.1f} GiB for the plain "
                         f"version's per-tile activations (> "
                         f"{_TILE_LIMIT_BYTES >> 30} GiB guard); use a smaller tile")


def _check_eps_hbm_budget(epochs: int, n_pad: int, latent_dim: int,
                          compute_dtype, limit_bytes: int = _EPS_HBM_LIMIT_BYTES):
    """The hbm mode holds every epoch's ε at once: refuse sizes over the
    guard and point at the prng mode, whose semantics are the same."""
    itemsize = 4 if compute_dtype is None else 2
    elems = epochs * n_pad * latent_dim
    need = elems * (4 + itemsize)  # float32 draw + the cast buffer
    if need > limit_bytes:
        raise ValueError(
            f"noise='hbm' peaks at {need / 2**30:.1f} GiB for the eps buffer "
            f"and its float32 draw ({epochs} epochs x {n_pad} rows x {latent_dim}) "
            f"— over the {limit_bytes >> 30} GiB guard; use noise='prng' (same "
            f"statistical semantics, drawn in the kernel)")


def _noise_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for stream ``stream`` of ``seed`` —
    the counterpart of ``jax.random.fold_in(key(seed), stream)``."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(stream)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


def hbm_noise_impl(device) -> str:
    """The name of the generator behind the hbm ε stream on ``device``."""
    return ("torch.randn/cuda-philox4x32-10" if torch.device(device).type == "cuda"
            else "torch.randn/cpu-mt19937")


def hbm_noise(seed: int, epochs: int, n_pad: int, latent_dim: int,
              compute_dtype, device) -> torch.Tensor:
    """Every epoch's ε, drawn flat in float32 (stream 1 of ``seed``), cast to
    the compute dtype and shaped (epochs·n_pad, Z), epoch-major."""
    g = _noise_generator(seed, 1, device)
    eps = torch.randn(epochs * n_pad * latent_dim, generator=g, device=device,
                      dtype=torch.float32)
    return eps.to(_torch_dtype(compute_dtype)).reshape(epochs * n_pad, latent_dim)


# ---- the plain version of one epoch's gradient pass -------------------------

def _check_ablate(ablate, compute_dtype, backward="manual") -> int:
    """K3's knob names → their bitmask; refuses what JAX refuses, and knobs
    beside the autodiff backward (they turn the manual backward)."""
    ablate = tuple(ablate)
    if ablate and backward != "manual":
        raise ValueError("the _ablate knobs apply to backward='manual'")
    bad = [k for k in ablate if k not in ABLATE_BITS]
    if bad:
        raise ValueError(f"unknown _ablate knobs {bad}; known: {sorted(ABLATE_BITS)}")
    if "chaincd" in ablate and compute_dtype is None:
        raise ValueError("chain_cd requires a compute dtype (it keeps the "
                         "dY chain in that dtype)")
    return sum(ABLATE_BITS[k] for k in set(ablate))


def _manual_levers(ablate) -> dict:
    """The manual-backward levers that ``ablate`` turns (nodw before
    fwdonly, as JAX :248-253 orders them)."""
    out = {}
    for k in ("biasdot", "dwT", "chaincd", "fwdonly", "nodw"):
        if k in ablate:
            name, val = _KNOB_LEVERS[k]
            out[name] = val
    return out


def _plain_grad_epoch(plist, packed, tile, cfg, weights, n_valid, compute_dtype,
                      eps_of_tile, ablate=(), backward="manual", mixed_style="f32_acts"):
    """Tile-summed gradients and loss row of one epoch: per tile the ported
    manual backward (or, for ``backward="auto"``, autograd of
    ``_forward_loss`` in ``mixed_style``) with the loss scaled by the
    global ``n_valid``, summed over the tiles in order, as the TPU kernels
    accumulate them.  Under the ``noacc`` knob each tile's gradient
    replaces the sum, so the last tile's is returned; the loss row sums
    every tile either way."""
    _check_plain_tile(tile)
    F, C = cfg.seq_len * cfg.dim, cfg.cond_dim
    if backward == "manual":
        value_and_grad = manual_value_and_grad
        levers = _manual_levers(ablate)
    else:
        value_and_grad = autodiff_value_and_grad
        levers = {"mixed_style": mixed_style}
    acc, row = None, None
    for i in range(packed.shape[0] // tile):
        blk = packed[i * tile:(i + 1) * tile]
        comps, grads = value_and_grad(
            plist, blk[:, :F], blk[:, F:F + C], eps_of_tile(i, blk), cfg, weights,
            blk[:, F + C:F + C + 1].float(), n_valid=n_valid,
            compute_dtype=compute_dtype, **levers)
        if acc is None:
            acc, row = grads, comps
        else:
            acc = grads if "noacc" in ablate else [a + g for a, g in zip(acc, grads)]
            row = row + comps
    return acc, row


def _eps_source(noise, cfg, tile, n_pad, eps_rows, seed_base, device):
    """→ eps_of_tile(i, block) for one epoch: the packed columns, rows of
    this epoch's hbm stream, or the Philox draw of key seed_base + i."""
    F, C, Z = cfg.seq_len * cfg.dim, cfg.cond_dim, cfg.latent_dim
    if noise == "packed":
        return lambda i, blk: blk[:, F + C + 1:F + C + 1 + Z]
    if noise == "hbm":
        return lambda i, blk: eps_rows[i * tile:(i + 1) * tile]
    return lambda i, blk: philox_normal(seed_base + i, 0, tile, Z, device)


def _check_noise(noise, packed, cfg, eps, rows, tile):
    if packed.shape[0] == 0 or packed.shape[0] % tile:
        raise ValueError(f"{packed.shape[0]} corpus rows are not a positive multiple "
                         f"of tile={tile}")
    width = cfg.seq_len * cfg.dim + cfg.cond_dim + 1
    if noise not in NOISE_MODES:
        raise ValueError(f"noise must be one of {sorted(NOISE_MODES)} (got {noise!r})")
    want = width + (cfg.latent_dim if noise == "packed" else 0)
    if packed.ndim != 2 or packed.shape[1] != want:
        raise ValueError(f"packed corpus has shape {tuple(packed.shape)}; noise="
                         f"{noise!r} needs {want} columns")
    if noise == "hbm":
        if eps is None or tuple(eps.shape) != (rows, cfg.latent_dim):
            raise ValueError(f"noise='hbm' needs an eps stream of shape "
                             f"({rows}, {cfg.latent_dim})")
        if eps.dtype != packed.dtype or eps.device != packed.device:
            raise ValueError("the eps stream must match the corpus's dtype and device")


# ---- the CUDA kernels' wrappers --------------------------------------------

def _kernel_common(plist, packed, eps, cfg, compute_dtype, tile, name, auto=False):
    """The checks and buffers both kernels share → (library, params packed
    flat, partial-row buffer, SM count, stream).  The autodiff instances
    cut the corpus into chunks within tiles, so they may take more rows."""
    from ._build import load

    if cfg != _KERNEL_CFG:
        raise ValueError(f"{name}: compiled for {_KERNEL_CFG}, got {cfg}")
    if packed.dtype != _torch_dtype(compute_dtype) or not packed.is_contiguous():
        raise ValueError(f"{name}: the corpus must be contiguous "
                         f"{_torch_dtype(compute_dtype)} for compute_dtype={compute_dtype}")
    if eps is not None and not eps.is_contiguous():
        raise ValueError(f"{name}: the eps stream must be contiguous")
    if packed.shape[0] % tile:
        raise ValueError(f"{name}: {packed.shape[0]} corpus rows are not a multiple "
                         f"of tile={tile}")
    lib = load("fused_scale")
    dev = packed.device
    params = pack_kernel_params(plist)
    if params.numel() != lib.ks_param_floats() or params.device != dev:
        raise ValueError(f"{name}: parameter list does not match the compiled model")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = (lib.ks_chunks_auto(packed.shape[0], tile, sms) if auto
              else lib.ks_chunks(packed.shape[0], sms))
    partial = torch.empty(int(chunks) * int(lib.ks_partial_floats()),
                          dtype=torch.float32, device=dev)
    return lib, params, partial, sms, torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _weights_args(weights: LossWeights):
    return (ctypes.c_float(weights.recon), ctypes.c_float(weights.kld),
            ctypes.c_float(weights.start), ctypes.c_float(weights.time))


_STEP_ROWS = 32  # the rows of one step of the CUDA gradient kernel


def _check_kernel_knobs(bits, compute_dtype, tile):
    """What the CUDA kernel takes of the knobs: one per-tile knob at a time
    (each is its own compiled instance, built for bf16 only), with noadam
    beside it; noacc needs tiles of whole 32-row steps."""
    knobs = bits & ~ABLATE_BITS["noadam"]
    if knobs & (knobs - 1):
        raise NotImplementedError("K3 is compiled for one ablation knob at a time "
                                  "(besides noadam)")
    if knobs and compute_dtype != "bfloat16":
        raise NotImplementedError("K3's ablation knobs are compiled for "
                                  "compute_dtype='bfloat16' only")
    if bits & ABLATE_BITS["noacc"] and tile % _STEP_ROWS:
        raise ValueError(f"the noacc knob needs a tile of whole {_STEP_ROWS}-row "
                         f"kernel steps (got {tile})")


def _fused_scale_call_auto_kernel(plist, packed, seed, cfg, weights, epochs, lr, tile,
                                  n_valid, compute_dtype, noise, eps_all, mixed_style):
    """K3's autodiff instance: k3_train_auto in the mode of
    (``compute_dtype``, ``mixed_style``), counted by mode in
    ``_fused_scale_call.auto_launches``."""
    mode = _auto_mode(compute_dtype, mixed_style)
    lib, params, partial, sms, stream = _kernel_common(plist, packed, eps_all, cfg,
                                                       compute_dtype, tile, "K3", auto=True)
    mv = torch.zeros(2 * params.numel(), dtype=torch.float32, device=packed.device)
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=packed.device)
    err = lib.k3_train_auto(
        packed.data_ptr(), packed.shape[1], _ptr(eps_all), AUTO_MODES[mode],
        NOISE_MODES[noise], packed.shape[0], tile, ctypes.c_float(n_valid), epochs,
        ctypes.c_float(lr), *_weights_args(weights), ctypes.c_ulonglong(seed),
        params.data_ptr(), mv.data_ptr(), partial.data_ptr(), sms, metrics.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"K3 ({mode} autodiff) launch failed: CUDA error {err}")
    _fused_scale_call.auto_launches[mode] += 1
    return unpack_kernel_params(params, plist), metrics


def _fused_scale_call_kernel(plist, packed, seed, cfg, weights, epochs, lr, tile,
                             n_valid, compute_dtype, noise, eps_all, bits=0, sink=None):
    """K3's launch.  Under the noadam bit the reduce writes each epoch's
    summed gradients, in the kernel's flat layout, to ``sink`` (allocated
    here when None), which is how a check reads a knob's gradients."""
    _check_kernel_knobs(bits, compute_dtype, tile)
    lib, params, partial, sms, stream = _kernel_common(plist, packed, eps_all, cfg,
                                                       compute_dtype, tile, "K3")
    mv = torch.zeros(2 * params.numel(), dtype=torch.float32, device=packed.device)
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=packed.device)
    if bits & ABLATE_BITS["noadam"] and sink is None:
        sink = torch.empty_like(params)
    if sink is not None and (sink.numel() != params.numel() or sink.device != params.device
                             or sink.dtype != torch.float32 or not sink.is_contiguous()):
        raise ValueError("K3: the sink must be a contiguous float32 tensor of the "
                         "kernel's parameter count on the corpus's device")
    err = lib.k3_train(
        packed.data_ptr(), packed.shape[1], _ptr(eps_all),
        int(packed.dtype == torch.bfloat16), NOISE_MODES[noise],
        packed.shape[0], tile, ctypes.c_float(n_valid), epochs, ctypes.c_float(lr),
        *_weights_args(weights), ctypes.c_ulonglong(seed),
        params.data_ptr(), mv.data_ptr(), partial.data_ptr(), sms,
        metrics.data_ptr(), bits, _ptr(sink), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    _fused_scale_call.launches += 1
    for knob, bit in ABLATE_BITS.items():
        if bits & bit:
            _fused_scale_call.knob_launches[knob] += 1
    return unpack_kernel_params(params, plist), metrics


def _grad_epoch_call_kernel(plist, packed, stream_base, cfg, weights, tile,
                            n_valid, compute_dtype, noise, eps_epoch, backward="manual",
                            mixed_style="f32_acts"):
    auto = backward == "auto"
    lib, params, partial, sms, stream = _kernel_common(plist, packed, eps_epoch, cfg,
                                                       compute_dtype, tile, "K4", auto)
    grad = torch.empty_like(params)
    row = torch.zeros((1, 8), dtype=torch.float32, device=packed.device)
    mode = _auto_mode(compute_dtype, mixed_style)
    args = (packed.data_ptr(), packed.shape[1], _ptr(eps_epoch),
            AUTO_MODES[mode] if auto else int(packed.dtype == torch.bfloat16),
            NOISE_MODES[noise], packed.shape[0], tile, ctypes.c_float(n_valid),
            *_weights_args(weights), ctypes.c_ulonglong(stream_base),
            params.data_ptr(), partial.data_ptr(), sms, grad.data_ptr(),
            row.data_ptr(), stream)
    err = lib.k4_grad_epoch_auto(*args) if auto else lib.k4_grad_epoch(*args)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    if auto:
        _grad_epoch_call.auto_launches[mode] += 1
    else:
        _grad_epoch_call.launches += 1
    return unpack_kernel_params(grad, plist), row


# ---- K3 ----------------------------------------------------------------------

def _fused_scale_call_plain(plist, packed, seed, cfg, weights, epochs, lr, tile,
                            n_valid, compute_dtype, noise, eps_all=None, _ablate=(),
                            backward="manual", mixed_style="f32_acts"):
    """K3's plain version: per epoch the plain gradient pass over the tiles
    in order, then Adam (none under the ``noadam`` knob); one metrics row
    [total, recon, kld, start, time, 0, 0, 0] per epoch."""
    _check_ablate(_ablate, compute_dtype, backward)
    dev = packed.device
    n_pad = packed.shape[0]
    n_tiles = n_pad // tile
    params = [a.clone() for a in plist]
    m = [torch.zeros_like(a) for a in plist]
    v = [torch.zeros_like(a) for a in plist]
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=dev)
    for e in range(epochs):
        rows = None if eps_all is None else eps_all[e * n_pad:(e + 1) * n_pad]
        src = _eps_source(noise, cfg, tile, n_pad, rows, seed + e * n_tiles, dev)
        grads, row = _plain_grad_epoch(params, packed, tile, cfg, weights, n_valid,
                                       compute_dtype, src, _ablate, backward, mixed_style)
        if "noadam" not in _ablate:
            tf = torch.tensor(float(e + 1), dtype=torch.float32, device=dev)
            params, m, v = _adam_step(params, grads, m, v, tf, lr)
        metrics[e, :5] = row
    return params, metrics


def _fused_scale_call(plist, packed, seed: int, cfg: CVAEConfig,
                      weights: LossWeights, epochs: int, lr: float, tile: int,
                      n_valid: float, compute_dtype, noise: str,
                      eps_all: Optional[torch.Tensor] = None, _ablate=(),
                      backward: Optional[str] = None, mixed_style: str = "f32_acts"):
    """A whole production-scale run: (final flat params, (epochs, 8) metrics).

    ``packed`` is the (n_pad, F+C+1[+Z]) corpus from :func:`_pack_corpus`,
    padded to a multiple of ``tile`` and stored in the compute dtype.  With
    ``noise="hbm"``, ``eps_all`` is the (epochs·n_pad, Z) stream; when it is
    None it is drawn here by :func:`hbm_noise`.  On CUDA tensors this
    launches K3 (counted in ``_fused_scale_call.launches``, those under
    each knob also in ``.knob_launches``; the autodiff instances by mode in
    ``_fused_scale_call.auto_launches``) or raises; on
    CPU tensors it runs K3's plain version.  ``backward`` is resolved by
    :func:`_resolve_backward`; ``_ablate`` names the ablation knobs (module
    docstring)."""
    backward = _resolve_backward(backward, compute_dtype, mixed_style)
    bits = _check_ablate(_ablate, compute_dtype, backward)
    dev = packed.device
    if noise == "hbm" and eps_all is None:
        eps_all = hbm_noise(seed, epochs, packed.shape[0], cfg.latent_dim,
                            compute_dtype, dev)
    _check_noise(noise, packed, cfg, eps_all, epochs * packed.shape[0], tile)
    if dev.type == "cpu":
        return _fused_scale_call_plain(plist, packed, seed, cfg, weights, epochs, lr,
                                       tile, n_valid, compute_dtype, noise, eps_all,
                                       tuple(_ablate), backward, mixed_style)
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or (plain) CPU tensors, got {dev}")
    if backward == "auto":
        return _fused_scale_call_auto_kernel(plist, packed, seed, cfg, weights, epochs,
                                             lr, tile, n_valid, compute_dtype, noise,
                                             eps_all, mixed_style)
    return _fused_scale_call_kernel(plist, packed, seed, cfg, weights, epochs, lr,
                                    tile, n_valid, compute_dtype, noise, eps_all, bits)


_fused_scale_call.launches = 0
_fused_scale_call.knob_launches = dict.fromkeys(ABLATE_BITS, 0)
_fused_scale_call.auto_launches = dict.fromkeys(AUTO_MODES, 0)


def _scale_inputs(windows, cfg, tile, compute_dtype, eps, dev):
    """Windows → (n, packed corpus padded to a multiple of ``tile`` with
    masked zero rows, in the compute dtype)."""
    x_flat, start = fused_inputs(windows, dev)
    n = x_flat.shape[0]
    n_pad = -(-n // tile) * tile
    eps_t = (None if eps is None
             else torch.as_tensor(np.asarray(eps, np.float32)).to(dev))
    packed = _pack_corpus(x_flat, start, torch.ones(n, device=dev), eps_t,
                          cfg.latent_dim)
    if n_pad != n:
        packed = torch.cat([packed, torch.zeros((n_pad - n, packed.shape[1]),
                                                device=dev)])
    return n, packed.to(_torch_dtype(compute_dtype)).contiguous()


def _history(metrics) -> Dict[str, np.ndarray]:
    m = metrics[:, :5].cpu().numpy()
    return {k: m[:, i] for i, k in enumerate(FUSED_METRIC_KEYS)}


def fused_train_scale(windows: np.ndarray, epochs: int = 200, lr: float = 1e-3,
                      weights: LossWeights = LossWeights(), seed: int = 0,
                      tile: int = 2048, compute_dtype: Optional[str] = "bfloat16",
                      mixed_style: str = "f32_acts", eps: np.ndarray = None,
                      noise: str = "hbm", backward: Optional[str] = None,
                      device="cuda") -> Tuple[Params, Dict[str, np.ndarray]]:
    """Train on a production-scale corpus in one K3 call (fused_scale.py:394).

    Full-batch Adam on the whole corpus, streamed in ``tile``-row blocks
    with the gradients summed over the tiles: same init (from
    ``torch.Generator().manual_seed(seed)``), objective and optimizer as the
    other trainers.  Rows are padded to a multiple of ``tile`` with masked
    zero windows.  ``compute_dtype="bfloat16"`` (the default) stores the
    corpus in bf16 and runs the products on bf16 operands over float32
    master weights (``f32_acts``; ``mixed_style="bf16_chain"`` is the scan
    trainer's whole-chain bf16); None is pure float32.  ``eps`` (N, Z),
    when given, is held constant over the epochs and overrides ``noise``
    (``"hbm"`` or ``"prng"``, module docstring).  ``backward``: None (the
    manual backward where it applies), ``"manual"`` or ``"auto"``.
    Returns (params, history)."""
    cfg, noise, backward = _check_scale_args(windows, tile, compute_dtype, mixed_style,
                                             eps, noise, backward)
    if noise == "hbm":
        n_pad = -(-windows.shape[0] // tile) * tile
        _check_eps_hbm_budget(epochs, n_pad, cfg.latent_dim, compute_dtype)
    dev = resolve_device(device)
    n, packed = _scale_inputs(windows, cfg, tile, compute_dtype, eps, dev)
    plist = _flatten_params(init_params(torch.Generator().manual_seed(seed), cfg, dev))
    out, metrics = _fused_scale_call(plist, packed, seed, cfg, weights, epochs, lr,
                                     tile, float(n), compute_dtype, noise,
                                     backward=backward, mixed_style=mixed_style)
    return _unflatten_params(out), _history(metrics)


# ---- K4 ----------------------------------------------------------------------

def _grad_epoch_call(plist, packed, stream_base: int, cfg: CVAEConfig,
                     weights: LossWeights, tile: int, n_valid: float,
                     compute_dtype, noise: str,
                     eps_epoch: Optional[torch.Tensor] = None,
                     backward: Optional[str] = None, mixed_style: str = "f32_acts"):
    """One epoch's (tile-summed flat gradients, (1, 8) loss row) over one
    device's corpus.  ``eps_epoch`` ((n_pad, Z), required for
    ``noise="hbm"``) is this epoch's stream; ``prng`` keys tile i by
    ``stream_base + i``.  On CUDA tensors this launches K4 (counted in
    ``_grad_epoch_call.launches``; the autodiff instances by mode in
    ``_grad_epoch_call.auto_launches``) or raises; on CPU tensors it runs
    K4's plain version."""
    backward = _resolve_backward(backward, compute_dtype, mixed_style)
    dev = packed.device
    _check_noise(noise, packed, cfg, eps_epoch, packed.shape[0], tile)
    if dev.type == "cpu":
        src = _eps_source(noise, cfg, tile, packed.shape[0], eps_epoch,
                          stream_base, dev)
        grads, row = _plain_grad_epoch(plist, packed, tile, cfg, weights, n_valid,
                                       compute_dtype, src, backward=backward,
                                       mixed_style=mixed_style)
        return grads, torch.cat([row, torch.zeros(3)]).reshape(1, 8)
    if dev.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or (plain) CPU tensors, got {dev}")
    return _grad_epoch_call_kernel(plist, packed, stream_base, cfg, weights, tile,
                                   n_valid, compute_dtype, noise, eps_epoch, backward,
                                   mixed_style)


_grad_epoch_call.launches = 0
_grad_epoch_call.auto_launches = dict.fromkeys(AUTO_MODES, 0)


def fused_train_scale_dp(windows: np.ndarray, mesh=None, epochs: int = 200,
                         lr: float = 1e-3, weights: LossWeights = LossWeights(),
                         seed: int = 0, tile: int = 2048,
                         compute_dtype: Optional[str] = "bfloat16",
                         mixed_style: str = "f32_acts", eps: np.ndarray = None,
                         noise: str = "hbm", backward: Optional[str] = None,
                         device="cuda") -> Tuple[Params, Dict[str, np.ndarray]]:
    """The per-epoch tier of :func:`fused_train_scale` (fused_scale.py:625):
    one K4 call per epoch for the tile-summed gradients, then Adam in torch.
    Same objective and optimizer as the whole-run trainer.

    ``mesh=None`` runs on one device (JAX's ``mesh=None``): the prng stream
    base of epoch e is seed + e·n_tiles and the hbm ε of epoch e is stream e
    of ``seed``.  The multi-device form (an all-reduce of the gradients over
    ``torch.distributed``) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError("fused_train_scale_dp over several devices (the "
                                  "gradient all-reduce) is not ported yet; pass "
                                  "mesh=None")
    cfg, noise, backward = _check_scale_args(windows, tile, compute_dtype, mixed_style,
                                             eps, noise, backward)
    dev = resolve_device(device)
    n, packed = _scale_inputs(windows, cfg, tile, compute_dtype, eps, dev)
    plist = _flatten_params(init_params(torch.Generator().manual_seed(seed), cfg, dev))
    local_tiles = packed.shape[0] // tile
    m = [torch.zeros_like(a) for a in plist]
    v = [torch.zeros_like(a) for a in plist]
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=dev)
    for e in range(epochs):
        eps_epoch = None
        if noise == "hbm":
            g = _noise_generator(seed, e, dev)
            eps_epoch = torch.randn((packed.shape[0], cfg.latent_dim), generator=g,
                                    device=dev).to(packed.dtype)
        grads, mrow = _grad_epoch_call(plist, packed, seed + e * local_tiles, cfg,
                                       weights, tile, float(n), compute_dtype, noise,
                                       eps_epoch, backward, mixed_style)
        tf = torch.tensor(float(e + 1), dtype=torch.float32, device=dev)
        plist, m, v = _adam_step(plist, grads, m, v, tf, lr)
        metrics[e] = mrow[0]
    return _unflatten_params(plist), _history(metrics)


# ---- the oracle ----------------------------------------------------------------

def fused_scale_reference(params: Params, windows: np.ndarray, eps, epochs: int,
                          lr: float = 1e-3, weights: LossWeights = LossWeights(),
                          tile: Optional[int] = None) -> Tuple[Params, np.ndarray]:
    """Plain tiled mirror of the trainers' accumulation by autograd of
    :func:`_forward_loss` (float32, explicit ε) — the oracle of
    fused_scale.py:847.  ``eps`` is (N, Z), held constant, or (epochs, N,
    Z), one draw per epoch.  ``tile=None`` is full batch; a ``tile`` sums
    the per-tile gradients in tile order.  → (params, (epochs, 5) history)."""
    cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    plist = [a.detach().clone() for a in _flatten_params(params)]
    dev = plist[0].device
    x_flat, start = fused_inputs(windows, dev)
    n = x_flat.shape[0]
    eps_t = torch.as_tensor(np.asarray(eps, np.float32)).to(dev)
    per_epoch = eps_t.ndim == 3
    mask = torch.ones((n, 1), device=dev)
    tile = n if tile is None else tile
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        pad = n_pad - n
        x_flat = torch.cat([x_flat, torch.zeros((pad, x_flat.shape[1]), device=dev)])
        start = torch.cat([start, torch.zeros((pad, start.shape[1]), device=dev)])
        zpad = torch.zeros(eps_t.shape[:-2] + (pad, eps_t.shape[-1]), device=dev)
        eps_t = torch.cat([eps_t, zpad], dim=-2)
        mask = torch.cat([mask, torch.zeros((pad, 1), device=dev)])
    m = [torch.zeros_like(p) for p in plist]
    v = [torch.zeros_like(p) for p in plist]
    hist = []
    for t in range(epochs):
        eps_e = eps_t[t] if per_epoch else eps_t
        acc, comps_sum = None, None
        for i in range(n_pad // tile):
            sl = slice(i * tile, (i + 1) * tile)
            pl_ = [p.clone().requires_grad_(True) for p in plist]
            _, comps = _forward_loss(pl_, x_flat[sl], start[sl], eps_e[sl], cfg,
                                     weights, mask[sl], n_valid=float(n))
            grads = torch.autograd.grad(comps[0], pl_)
            comps = comps.detach()
            acc = list(grads) if acc is None else [a + g for a, g in zip(acc, grads)]
            comps_sum = comps if comps_sum is None else comps_sum + comps
        tf = torch.tensor(float(t + 1), dtype=torch.float32, device=dev)
        plist, m, v = _adam_step(plist, acc, m, v, tf, lr)
        hist.append(comps_sum.cpu().numpy())
    return _unflatten_params(plist), np.stack(hist)
