"""Whole-run fused CVAE trainer: kernel K1 and its plain version.

Port of ``defensive_model_vae_tpu/ops/fused_trainer.py``.  There, one
Pallas kernel (``_make_kernel`` :326, launched by ``_fused_call`` :375)
runs an entire E-epoch full-batch training of one scenario CVAE with the
parameters and Adam state resident in VMEM.  Here the same contract — x,
cond, optional ε, seed and the initial params in; the final params and an
(E, 8) metrics block out — is one launch of the CUDA kernel
``csrc/fused_trainer.cu`` (one thread block runs one whole training run;
see the design note in that file for its bound and its layout).

Plain parts ported as they are: ``_LAYERS``/``_flatten_params``/
``_unflatten_params`` (:38-58), ``_forward_loss`` (:61; float32 and both
mixed styles, ``f32_acts`` and ``bf16_chain``), ``_check_backward_arg``
(:204), ``_adam_step`` (:268), ``fused_inputs`` (:442),
``fused_step_reference`` (:795) and ``fused_train`` (:405).

``backward`` (JAX's ``_epoch_body`` :287-323): ``"manual"`` runs the
hand-written backward of ``manual_grad``; ``"auto"`` runs the arithmetic
of autodiff of ``_forward_loss`` — the μ and logσ² heads' products apart,
the loss terms' cotangents added term by term.  In the kernels these are
two instances of one run (``csrc/fused_trainer.cu``); their plain versions
are the manual backward and autograd of :func:`_forward_loss`.

Noise: the TPU kernel draws ε from the core PRNG.  K1 draws it from a
Philox4x32-10 counter generator keyed by the seed with counter (epoch, row,
column group), then Box–Muller; :func:`philox_normal` is the same generator
in torch, so the plain version and the kernel draw the same ε.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, init_params, to_relative
from ..models.cvae import Params

FUSED_METRIC_KEYS = ("total", "recon", "kld", "start", "time")

_LAYERS = (
    "cond_0", "cond_1",
    "enc_0", "enc_1", "enc_2", "enc_3",
    "fc_mu", "fc_logvar",
    "dec_0", "dec_1", "dec_2", "dec_3",
)

# the one model shape the CUDA kernel is compiled for (CVAEConfig defaults)
_K1_CFG = CVAEConfig()


def _flatten_params(params: Params) -> List[torch.Tensor]:
    flat = []
    for name in _LAYERS:
        flat.append(params[name]["w"])
        flat.append(params[name]["b"].reshape(1, -1))
    return flat


def _unflatten_params(flat) -> Params:
    return {name: {"w": flat[2 * i], "b": flat[2 * i + 1].reshape(-1)}
            for i, name in enumerate(_LAYERS)}


def bf16_rounder(compute_dtype):
    """→ dc(a): a product operand in the compute dtype, held in float32 —
    ``a.to(bfloat16).float()`` (round to nearest even) for ``"bfloat16"``,
    the identity for None."""
    if compute_dtype is None:
        return lambda a: a
    if compute_dtype == "bfloat16":
        return lambda a: a.to(torch.bfloat16).float()
    raise ValueError(f"compute_dtype must be None or 'bfloat16' (got {compute_dtype!r})")


def _forward_loss(plist, x_flat, cond, eps, cfg: CVAEConfig, w: LossWeights,
                  mask=None, n_valid=None, compute_dtype=None,
                  mixed_style="f32_acts"):
    """Loss over the flat param list on flattened (B, T·D) windows with
    explicit noise (fused_trainer.py:61).  Returns (total, [total, recon,
    kld, start, time]).

    With ``compute_dtype="bfloat16"``, JAX's two mixed styles, emulated in
    float32 with explicit rounding to bf16 (nearest even) so that no
    product depends on how a library reduces bf16:

    - ``"f32_acts"``: the inputs are taken to float32 once, both operands
      of every product are rounded to bf16 and the product accumulates in
      float32; everything else stays float32;
    - ``"bf16_chain"`` (the scan trainer's recipe, JAX :61-200): params and
      inputs are bf16; each product accumulates in float32 and is rounded,
      then the bf16 bias is added and the sum rounded; relu is a select on
      ``h > 0``; ``std = bf16(exp(0.5·f32(logvar)))`` and ``z = bf16(mu +
      bf16(eps·std))``; recon, mu and logvar go up to float32 for the loss.

    Under autograd each rounding's backward casts its cotangent to bf16 and
    back, which is where JAX's autodiff rounds: at every cast's VJP, so a
    product's cotangent in an operand is rounded per use.  In
    ``bf16_chain`` every bf16 value is therefore rounded once where it is
    made (its summed cotangent, as JAX adds bf16 cotangents in bf16) and
    once at each use (that use's cotangent).  With None the roundings are
    absent and this is the float32 path as it always was."""
    chain = compute_dtype is not None and mixed_style == "bf16_chain"
    if compute_dtype is not None and mixed_style not in ("f32_acts", "bf16_chain"):
        raise ValueError(f"mixed_style must be 'f32_acts' or 'bf16_chain' "
                         f"(got {mixed_style!r})")
    dc = bf16_rounder(compute_dtype)
    if compute_dtype is not None:
        x_flat, cond, eps = x_flat.float(), cond.float(), eps.float()
    if chain:
        x_flat, cond, eps = dc(x_flat), dc(cond), dc(eps)
        plist = [dc(a) for a in plist]
    p = {n: (plist[2 * i], plist[2 * i + 1]) for i, n in enumerate(_LAYERS)}

    def lin(name, h):
        if chain:
            return dc(dc(dc(h) @ p[name][0]) + p[name][1])
        return dc(h) @ dc(p[name][0]) + p[name][1]

    if chain:
        def relu(h):
            return torch.where(h > 0, h, torch.zeros((), dtype=h.dtype, device=h.device))
    else:
        relu = torch.relu

    hc = relu(lin("cond_1", relu(lin("cond_0", cond))))
    h = x_flat
    for name in ("enc_0", "enc_1", "enc_2", "enc_3"):
        h = relu(lin(name, h))
    hcat = torch.cat([h, hc], dim=1)
    if chain:
        hcat = dc(hcat)
    mu = lin("fc_mu", hcat)
    logvar = lin("fc_logvar", hcat)
    if chain:
        std = dc(torch.exp(0.5 * dc(logvar)))
        z = dc(mu + dc(eps * std))
        mu, logvar = dc(mu), dc(logvar)   # their float32 uses in the loss
    else:
        z = mu + eps * torch.exp(0.5 * logvar)
    g = torch.cat([z, hc], dim=1)
    for name in ("dec_0", "dec_1", "dec_2"):
        g = relu(lin(name, g))
    recon = lin("dec_3", g)
    if chain:
        recon = dc(recon)

    T, D = cfg.seq_len, cfg.dim
    if mask is None:
        mean_rows = torch.mean
    else:
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
    total = (w.recon * recon_loss + w.kld * kld
             + w.start * start_loss + w.time * time_loss)
    return total, torch.stack([total, recon_loss, kld, start_loss, time_loss])


def autodiff_value_and_grad(plist, x_flat, cond, eps, cfg: CVAEConfig,
                            w: LossWeights, mask=None, n_valid=None,
                            compute_dtype=None, mixed_style="f32_acts"):
    """``(comps, grads)`` by autograd of :func:`_forward_loss` — the plain
    version of every ``backward="auto"`` kernel, as JAX's
    ``jax.value_and_grad(_forward_loss)`` is (fused_scale.py:120-144).
    Products run in float32 (callers on the card keep TF32 off)."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in plist]
        total, comps = _forward_loss(leaves, x_flat, cond, eps, cfg, w, mask, n_valid,
                                     compute_dtype, mixed_style)
        grads = torch.autograd.grad(total, leaves)
    return comps.detach(), [g.detach() for g in grads]


def _check_backward_arg(backward):
    """K1's instances are float32, so both gradient paths are always
    available (fused_trainer.py:204-210)."""
    if backward not in ("auto", "manual"):
        raise ValueError(f"backward must be 'auto' or 'manual' (got {backward!r})")


_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_step(params, grads, m, v, tf, lr):
    """One Adam update over flat lists (optax defaults; fused_trainer.py:268).
    ``tf`` is the 1-based step as a float32 tensor; bias correction is
    ``1 - exp(t·ln b)`` as in the TPU kernel and in K1."""
    bc1 = 1.0 - torch.exp(tf * math.log(_B1))
    bc2 = 1.0 - torch.exp(tf * math.log(_B2))
    new_p, new_m, new_v = [], [], []
    for p, g, mi, vi in zip(params, grads, m, v):
        mi = _B1 * mi + (1 - _B1) * g
        vi = _B2 * vi + (1 - _B2) * g * g
        new_p.append(p - lr * ((mi / bc1) / (torch.sqrt(vi / bc2) + _ADAM_EPS)))
        new_m.append(mi)
        new_v.append(vi)
    return new_p, new_m, new_v


# ---- Philox4x32-10 + Box–Muller (the kernel's noise, in torch) ------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a·b for a constant a and int64 tensor b
    holding uint32 values, in 16-bit pieces so nothing overflows int64."""
    al, ah = a & 0xFFFF, a >> 16
    t1 = al * b
    t2 = ah * b
    low = t1 + ((t2 & 0xFFFF) << 16)
    return ((t2 >> 16) + (low >> 32)) & _U32, low & _U32


def philox4x32(ctr, key):
    """Philox4x32-10 over int64 tensors holding uint32 words.
    ``ctr`` is a 4-tuple of tensors, ``key`` a 2-tuple of ints."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normal(seed: int, epoch: int, rows: int, cols: int,
                  device="cpu") -> torch.Tensor:
    """(rows, cols) N(0, 1) draws of epoch ``epoch`` — bit for bit the
    generator in ``csrc/fused_trainer.cu``: counter (epoch, row, col // 4, 0)
    keyed by (seed low, seed high); words (0, 1) and (2, 3) are two
    Box–Muller pairs over 24-bit uniforms, u1 = (w0 >> 8 + 1)·2⁻²⁴ ∈ (0, 1],
    giving r·cos and r·sin for columns 4k..4k+3."""
    groups = (cols + 3) // 4
    row = torch.arange(rows, dtype=torch.int64).repeat_interleave(groups)
    grp = torch.arange(groups, dtype=torch.int64).repeat(rows)
    zero = torch.zeros_like(row)
    words = philox4x32(
        (zero + (epoch & _U32), row, grp, zero),
        (seed & _U32, (seed >> 32) & _U32),
    )
    scale = 1.0 / (1 << 24)
    out = []
    for a, b in ((words[0], words[1]), (words[2], words[3])):
        u1 = ((a >> 8) + 1).to(torch.float32) * scale
        u2 = (b >> 8).to(torch.float32) * scale
        r = torch.sqrt(-2.0 * torch.log(u1))
        th = (2.0 * math.pi) * u2
        out += [r * torch.cos(th), r * torch.sin(th)]
    z = torch.stack(out, dim=1).reshape(rows, groups * 4)[:, :cols]
    return z.contiguous().to(device)


# ---- the kernel's flat parameter layout -------------------------------------

def _kernel_blocks(plist):
    """The 22 arrays of K1's flat layout: the twelve layers in ``_LAYERS``
    order with fc_mu/fc_logvar merged into one (2H, 2Z) head (manual_grad)."""
    out = []
    for i, name in enumerate(_LAYERS):
        if name == "fc_logvar":
            continue
        w, b = plist[2 * i], plist[2 * i + 1]
        if name == "fc_mu":
            w = torch.cat([w, plist[2 * i + 2]], dim=1)
            b = torch.cat([b, plist[2 * i + 3]], dim=1)
        out += [w, b]
    return out


def pack_kernel_params(plist) -> torch.Tensor:
    """Flat list → the contiguous (n_params,) f32 buffer the kernel updates."""
    return torch.cat([a.reshape(-1) for a in _kernel_blocks(plist)]).float().contiguous()


def unpack_kernel_params(flat: torch.Tensor, plist_like) -> List[torch.Tensor]:
    """Inverse of :func:`pack_kernel_params` (shapes from ``plist_like``)."""
    blocks = _kernel_blocks(plist_like)
    parts, off = [], 0
    for a in blocks:
        parts.append(flat[off:off + a.numel()].reshape(a.shape))
        off += a.numel()
    out = []
    for i, name in enumerate(_LAYERS):
        if name == "fc_logvar":
            continue
        w, b = parts.pop(0), parts.pop(0)
        if name == "fc_mu":
            z = plist_like[2 * i].shape[1]
            out += [w[:, :z], b[:, :z], w[:, z:], b[:, z:]]
        else:
            out += [w, b]
    return [a.contiguous() for a in out]


# ---- K1: the wrapper, its kernel and its plain version ----------------------

def _fused_call_plain(plist, x_flat, cond, seed, cfg, weights, epochs, lr, eps,
                      mask=None, backward="manual"):
    """K1's plain version: per epoch ε (explicit, or Philox), the gradients
    (the ported manual backward, or autograd of :func:`_forward_loss` for
    ``backward="auto"``, JAX's ``_epoch_body`` :287-323), Adam; one metrics
    row [total, recon, kld, start, time, 0, 0, 0] per epoch.  ``mask``
    (B, 1) makes the means masked ones over max(Σ mask, 1) rows (K2's padded
    rows)."""
    from .manual_grad import manual_value_and_grad

    _check_backward_arg(backward)
    value_and_grad = (manual_value_and_grad if backward == "manual"
                      else autodiff_value_and_grad)
    dev = x_flat.device
    params = [a.clone() for a in plist]
    m = [torch.zeros_like(a) for a in plist]
    v = [torch.zeros_like(a) for a in plist]
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=dev)
    B = x_flat.shape[0]
    for t in range(epochs):
        e = eps if eps is not None else philox_normal(seed, t, B, cfg.latent_dim, dev)
        comps, grads = value_and_grad(params, x_flat, cond, e, cfg, weights, mask=mask)
        tf = torch.tensor(float(t + 1), dtype=torch.float32, device=dev)
        params, m, v = _adam_step(params, grads, m, v, tf, lr)
        metrics[t, :5] = comps
    return params, metrics


def _check_kernel_inputs(kernel, cfg, dev, *arrays):
    """Refuse what the compiled kernel does not take: another model shape,
    or an input (name, tensor or None, shape) that is not contiguous float32
    of that shape on ``dev``."""
    if cfg != _K1_CFG:
        raise ValueError(f"{kernel} is compiled for {_K1_CFG}, got {cfg}")
    for name, a, shape in arrays:
        if a is None:
            continue
        if a.device != dev or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous float32 on {dev}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")


# the library's entry of each K1-family launch, by backward: the manual
# instances and the autodiff instance (its own object, fused_trainer.cu
# compiled with -DK1_AUTO)
_K1_ENTRIES = {"manual": ("k1_fused_train", "k2_fused_train_multi", "k1_fused_train_seeds"),
               "auto": ("k1_fused_train_auto", "k2_fused_train_multi_auto",
                        "k1_fused_train_seeds_auto")}


def _count_launch(fn, backward):
    if backward == "manual":
        fn.launches += 1
    else:
        fn.auto_launches += 1


def _fused_call_kernel(plist, x_flat, cond, seed, cfg, weights, epochs, lr, eps,
                       backward="manual"):
    from ._build import load

    B = x_flat.shape[0]
    F, C, Z = cfg.seq_len * cfg.dim, cfg.cond_dim, cfg.latent_dim
    dev = x_flat.device
    _check_kernel_inputs("K1", cfg, dev, ("x_flat", x_flat, (B, F)),
                         ("cond", cond, (B, C)), ("eps", eps, (B, Z)))
    lib = load("fused_trainer")
    params = pack_kernel_params(plist)
    if params.numel() != lib.k1_param_floats() or params.device != dev:
        raise ValueError("K1: parameter list does not match the compiled model")
    work = torch.empty(int(lib.k1_work_floats(B)), dtype=torch.float32, device=dev)
    metrics = torch.empty((epochs, 8), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, _K1_ENTRIES[backward][0])(
        x_flat.data_ptr(), cond.data_ptr(),
        None if eps is None else eps.data_ptr(),
        params.data_ptr(), work.data_ptr(), metrics.data_ptr(),
        B, epochs, ctypes.c_float(lr),
        ctypes.c_float(weights.recon), ctypes.c_float(weights.kld),
        ctypes.c_float(weights.start), ctypes.c_float(weights.time),
        ctypes.c_ulonglong(seed), stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    _count_launch(fused_call, backward)
    return unpack_kernel_params(params, plist), metrics


def fused_call(plist, x_flat, cond, seed: int, cfg: CVAEConfig,
               weights: LossWeights, epochs: int, lr: float,
               eps: Optional[torch.Tensor] = None, backward: str = "manual"):
    """One whole training run: (final flat params, (epochs, 8) metrics).

    On CUDA tensors this launches K1 (one launch, counted in
    ``fused_call.launches``, or ``fused_call.auto_launches`` for the
    autodiff instance) or raises; on CPU tensors it runs K1's plain
    version.  ``eps`` (B, Z), when given, is held constant across epochs
    (the TPU kernel's ``eps_input`` mode); otherwise ε is Philox noise.
    ``backward``: ``"manual"`` (the hand-written backward) or ``"auto"``
    (the arithmetic of autodiff of :func:`_forward_loss`)."""
    _check_backward_arg(backward)
    dev = x_flat.device
    if dev.type == "cpu":
        return _fused_call_plain(plist, x_flat, cond, seed, cfg, weights,
                                 epochs, lr, eps, backward=backward)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got {dev}")
    return _fused_call_kernel(plist, x_flat, cond, seed, cfg, weights,
                              epochs, lr, eps, backward)


fused_call.launches = 0
fused_call.auto_launches = 0


# ---- many runs in one launch: K2, and K1 on a grid of seeds -----------------
#
# ``stacked`` is the flat ``_LAYERS`` list with a leading run axis on every
# array, (S, in, out) and (S, 1, out), as JAX's ``_fused_multi_call`` takes
# it.  There is no epoch limit: the TPU's (``_check_grid_epoch_budget``) is
# VMEM's, and here the (S, E, 8) metrics and the S work regions of
# 3·128,942 + 2,164·B floats each lie in device memory, whose allocation
# raises before any launch when it does not fit.

def stack_flat_params(params_list) -> Tuple[torch.Tensor, ...]:
    """Per-run params → the stacked flat list the grid calls take."""
    flats = [_flatten_params(p) for p in params_list]
    return tuple(torch.stack(col) for col in zip(*flats))


def _run_params(stacked, s: int) -> List[torch.Tensor]:
    return [a[s] for a in stacked]


def _stack_runs(outs):
    """[(flat params, metrics)] of S runs → (stacked params, (S, E, 8))."""
    return (tuple(torch.stack(col) for col in zip(*(p for p, _ in outs))),
            torch.stack([m for _, m in outs]))


def _grid_call_kernel(entry, kernel, stacked, x_flat, cond, eps, seeds, cfg,
                      weights, epochs, lr, rows, row_off=None):
    """Launch S K1 runs in one grid through the library function ``entry``,
    with ``rows`` rows of ε and of work in all; → (stacked params,
    (S, E, 8))."""
    from ._build import load

    dev = x_flat.device
    S = len(seeds)
    lib = load("fused_trainer")
    plists = [_run_params(stacked, s) for s in range(S)]
    params = torch.stack([pack_kernel_params(p) for p in plists])
    if params.shape[1] != lib.k1_param_floats() or params.device != dev:
        raise ValueError(f"{kernel}: parameter list does not match the compiled model")
    w0, w1 = int(lib.k1_work_floats(0)), int(lib.k1_work_floats(1))
    work = torch.empty(S * w0 + rows * (w1 - w0), dtype=torch.float32, device=dev)
    metrics = torch.empty((S, epochs, 8), dtype=torch.float32, device=dev)
    # the seeds' 64 bits as int64, which the kernel reads as uint64 (as
    # ``fused_call`` passes one seed through ``c_ulonglong``)
    seeds_t = torch.tensor([(int(s) + 2 ** 63) % 2 ** 64 - 2 ** 63 for s in seeds],
                           dtype=torch.int64).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = [x_flat.data_ptr(), cond.data_ptr(), None if eps is None else eps.data_ptr()]
    tail = [ctypes.c_float(lr), ctypes.c_float(weights.recon),
            ctypes.c_float(weights.kld), ctypes.c_float(weights.start),
            ctypes.c_float(weights.time), stream]
    body = [params.data_ptr(), work.data_ptr(), metrics.data_ptr()]
    if row_off is None:
        err = getattr(lib, entry)(*head, seeds_t.data_ptr(), S, *body, x_flat.shape[0],
                                  epochs, *tail)
    else:
        off_t = torch.tensor(row_off, dtype=torch.int32).to(dev)
        err = getattr(lib, entry)(*head, off_t.data_ptr(), seeds_t.data_ptr(), S, *body,
                                  epochs, *tail)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    outs = [unpack_kernel_params(params[s], plists[s]) for s in range(S)]
    return tuple(torch.stack(col) for col in zip(*outs)), metrics


def _check_grid(kernel, stacked, x_flat, seeds, epochs):
    dev = x_flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA or (plain) CPU tensors, got {dev}")
    S = len(seeds)
    if S < 1 or epochs < 1:
        raise ValueError(f"{kernel}: needs at least one run and one epoch")
    if any(a.shape[0] != S or a.device != dev for a in stacked):
        raise ValueError(f"{kernel}: every stacked parameter needs {S} runs on {dev}")
    return dev


def _fused_multi_call_plain(stacked, x_flat, cond, row_off, seeds, cfg, weights,
                            epochs, lr, eps=None, backward="manual"):
    """K2's plain version in JAX's padded-and-masked form
    (fused_trainer.py:596-641): each run's rows padded to n_max with copies
    of its first row (ε rows zero), a (n_max, 1) row mask, masked means over
    max(Σ mask, 1) rows, Philox noise keyed by ``seeds[s]`` over n_max rows."""
    n = [row_off[s + 1] - row_off[s] for s in range(len(seeds))]
    n_max = max(n)
    outs = []
    for s, (lo, hi) in enumerate(zip(row_off[:-1], row_off[1:])):
        pad = n_max - n[s]

        def padded(a, fill):
            return torch.cat([a[lo:hi], fill.expand(pad, -1)])

        mask = torch.cat([torch.ones((n[s], 1)), torch.zeros((pad, 1))]).to(x_flat.device)
        e = None if eps is None else padded(eps, torch.zeros_like(eps[:1]))
        outs.append(_fused_call_plain(
            _run_params(stacked, s), padded(x_flat, x_flat[lo:lo + 1]),
            padded(cond, cond[lo:lo + 1]), int(seeds[s]), cfg, weights, epochs, lr,
            e, mask=mask, backward=backward))
    return _stack_runs(outs)


def _fused_multi_call(stacked, x_flat, cond, row_off: Sequence[int], seeds,
                      cfg: CVAEConfig, weights: LossWeights, epochs: int, lr: float,
                      eps: Optional[torch.Tensor] = None, backward: str = "manual"):
    """S whole training runs on ragged corpora: (stacked params, (S, E, 8)).

    Run s trains ``stacked[:, s]`` on rows ``row_off[s]:row_off[s + 1]`` of
    the concatenated ``x_flat`` (Σ B_s, T·D) and ``cond`` (Σ B_s, 2), with
    Philox noise keyed by ``seeds[s]`` or the same rows of an explicit
    ``eps`` (Σ B_s, Z) held constant over the epochs.  On CUDA tensors this
    launches K2 (one launch of S blocks, counted in
    ``_fused_multi_call.launches``, or ``.auto_launches`` for the autodiff
    instance) or raises; on CPU tensors it runs K2's plain version."""
    _check_backward_arg(backward)
    dev = _check_grid("K2", stacked, x_flat, seeds, epochs)
    row_off = [int(r) for r in row_off]
    if (len(row_off) != len(seeds) + 1 or row_off[0] != 0
            or row_off[-1] != x_flat.shape[0]
            or any(b <= a for a, b in zip(row_off[:-1], row_off[1:]))):
        raise ValueError(f"K2: row offsets {row_off} must rise from 0 to "
                         f"{x_flat.shape[0]} by at least one row a run")
    if dev.type == "cpu":
        return _fused_multi_call_plain(stacked, x_flat, cond, row_off, seeds, cfg,
                                       weights, epochs, lr, eps, backward)
    R = x_flat.shape[0]
    F, C, Z = cfg.seq_len * cfg.dim, cfg.cond_dim, cfg.latent_dim
    _check_kernel_inputs("K2", cfg, dev, ("x_flat", x_flat, (R, F)),
                         ("cond", cond, (R, C)), ("eps", eps, (R, Z)))
    out = _grid_call_kernel(_K1_ENTRIES[backward][1], "K2", stacked,
                            x_flat, cond, eps, seeds, cfg, weights, epochs, lr, R,
                            row_off)
    _count_launch(_fused_multi_call, backward)
    return out


_fused_multi_call.launches = 0
_fused_multi_call.auto_launches = 0


def _fused_seeds_call_plain(stacked, x_flat, cond, seeds, cfg, weights, epochs, lr,
                            eps=None, backward="manual"):
    """The seed grid's plain version: K1's, once per seed."""
    return _stack_runs([
        _fused_call_plain(_run_params(stacked, s), x_flat, cond, int(seed), cfg,
                          weights, epochs, lr, None if eps is None else eps[s],
                          backward=backward)
        for s, seed in enumerate(seeds)])


def _fused_seeds_call(stacked, x_flat, cond, seeds, cfg: CVAEConfig,
                      weights: LossWeights, epochs: int, lr: float,
                      eps: Optional[torch.Tensor] = None, backward: str = "manual"):
    """S whole training runs of one corpus: (stacked params, (S, E, 8)).

    Run s trains ``stacked[:, s]`` on all of ``x_flat``/``cond`` with
    Philox noise keyed by ``seeds[s]`` or the explicit ``eps[s]`` (of an
    (S, B, Z) ``eps``).  On CUDA tensors this launches K1 on a grid of S
    blocks (one launch, counted in ``_fused_seeds_call.launches``, or
    ``.auto_launches`` for the autodiff instance), each block K1's own run,
    or raises; on CPU tensors it runs K1's plain version once per seed."""
    _check_backward_arg(backward)
    dev = _check_grid("the seed grid", stacked, x_flat, seeds, epochs)
    if dev.type == "cpu":
        return _fused_seeds_call_plain(stacked, x_flat, cond, seeds, cfg, weights,
                                       epochs, lr, eps, backward)
    B, S = x_flat.shape[0], len(seeds)
    F, C, Z = cfg.seq_len * cfg.dim, cfg.cond_dim, cfg.latent_dim
    _check_kernel_inputs("K1", cfg, dev, ("x_flat", x_flat, (B, F)),
                         ("cond", cond, (B, C)), ("eps", eps, (S, B, Z)))
    out = _grid_call_kernel(_K1_ENTRIES[backward][2], "K1", stacked,
                            x_flat, cond, eps, seeds, cfg, weights, epochs, lr, S * B)
    _count_launch(_fused_seeds_call, backward)
    return out


_fused_seeds_call.launches = 0
_fused_seeds_call.auto_launches = 0


def fused_inputs(windows, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Windows (B, T, D) → ``(x_flat (B, T·D), start (B, 2))``, through the
    same :func:`to_relative` as the scan trainer (fused_trainer.py:442)."""
    batch = torch.as_tensor(np.asarray(windows, np.float32)).to(resolve_device(device))
    rel, start = to_relative(batch)
    return rel.reshape(batch.shape[0], -1).contiguous(), start.contiguous()


def _history(metrics) -> Dict[str, np.ndarray]:
    m = metrics[:, :5]
    return {k: m[:, i] for i, k in enumerate(FUSED_METRIC_KEYS)}


def fused_train(windows: np.ndarray, epochs: int = 3000, lr: float = 1e-3,
                weights: LossWeights = LossWeights(), seed: int = 0,
                eps=None, backward: str = "manual",
                device="cuda") -> Tuple[Params, Dict[str, np.ndarray]]:
    """Train one scenario CVAE in one K1 launch (fused_trainer.py:405).

    Same init (from ``torch.Generator().manual_seed(seed)``), loss and
    optimizer as :func:`..train.train`; the noise is K1's Philox stream
    unless ``eps`` (B, Z) is given.  ``backward``: ``"manual"`` (default)
    or ``"auto"`` (:func:`fused_call`).  Returns (params, history)."""
    _check_backward_arg(backward)
    dev = resolve_device(device)
    cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    x_flat, start = fused_inputs(windows, dev)
    params = init_params(torch.Generator().manual_seed(seed), cfg, dev)
    if eps is not None:
        eps = torch.as_tensor(np.asarray(eps, np.float32)).to(dev).contiguous()
    out_plist, metrics = fused_call(_flatten_params(params), x_flat, start,
                                    seed, cfg, weights, epochs, lr, eps, backward)
    return _unflatten_params(out_plist), _history(metrics.cpu().numpy())


def fused_train_multi(windows_by_scenario: Dict[str, np.ndarray], epochs: int = 3000,
                      lr: float = 1e-3, weights: LossWeights = LossWeights(),
                      seed: int = 0, eps_by_scenario: Optional[Dict[str, np.ndarray]] = None,
                      backward: str = "manual", device="cuda") -> Tuple[Dict[str, Params],
                                              Dict[str, Dict[str, np.ndarray]]]:
    """Train every scenario's model in ONE K2 launch (fused_trainer.py:574).

    Scenarios in sorted key order; scenario i is initialised from
    ``torch.Generator().manual_seed(seed + i)`` and draws Philox noise keyed
    by ``seed + i``, so it is :func:`fused_train` on its own windows with
    seed ``seed + i`` — not a per-scenario call with the same base seed.
    ``eps_by_scenario`` ({key: (B_i, Z)}) replaces the noise by explicit ε
    held constant over the epochs.  ``backward`` as :func:`fused_train`.
    → ({key: params}, {key: history})."""
    _check_backward_arg(backward)
    dev = resolve_device(device)
    keys = sorted(windows_by_scenario)
    first = windows_by_scenario[keys[0]]
    cfg = CVAEConfig(seq_len=first.shape[1], dim=first.shape[2])
    inputs = [fused_inputs(windows_by_scenario[k], dev) for k in keys]
    row_off = np.concatenate([[0], np.cumsum([len(x) for x, _ in inputs])]).tolist()
    x_flat = torch.cat([x for x, _ in inputs]).contiguous()
    cond = torch.cat([c for _, c in inputs]).contiguous()
    stacked = stack_flat_params(
        [init_params(torch.Generator().manual_seed(seed + i), cfg, dev)
         for i in range(len(keys))])
    eps = None
    if eps_by_scenario is not None:
        eps = torch.as_tensor(np.concatenate(
            [np.asarray(eps_by_scenario[k], np.float32) for k in keys])).to(dev)
    out, metrics = _fused_multi_call(stacked, x_flat, cond, row_off,
                                     [seed + i for i in range(len(keys))], cfg,
                                     weights, epochs, lr, eps, backward)
    metrics = metrics.cpu().numpy()
    return ({k: _unflatten_params(_run_params(out, i)) for i, k in enumerate(keys)},
            {k: _history(metrics[i]) for i, k in enumerate(keys)})


def fused_train_seeds(windows: np.ndarray, seeds, epochs: int = 3000, lr: float = 1e-3,
                      weights: LossWeights = LossWeights(),
                      eps_by_seed: Optional[Dict[int, np.ndarray]] = None,
                      backward: str = "manual", device="cuda") -> Tuple[Dict[int, Params],
                                              Dict[int, Dict[str, np.ndarray]]]:
    """Train one corpus under many seeds in ONE launch of K1 on a grid of
    S blocks (fused_trainer.py:661).

    Seed s is :func:`fused_train` with ``seed=s`` — the same init, the same
    Philox stream and the same per-block code — so its params and history
    are bit for bit those of the single run.  ``eps_by_seed`` ({seed:
    (B, Z)}) replaces the noise by explicit ε.  ``backward`` as
    :func:`fused_train`.  Duplicate seeds are refused (results are keyed by
    seed).  → ({seed: params}, {seed: history})."""
    _check_backward_arg(backward)
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError("duplicate seeds in fused_train_seeds")
    dev = resolve_device(device)
    cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    x_flat, start = fused_inputs(windows, dev)
    stacked = stack_flat_params([init_params(torch.Generator().manual_seed(s), cfg, dev)
                                 for s in seeds])
    eps = None
    if eps_by_seed is not None:
        eps = torch.as_tensor(np.stack(
            [np.asarray(eps_by_seed[s], np.float32) for s in seeds])).to(dev)
    out, metrics = _fused_seeds_call(stacked, x_flat, start, seeds, cfg, weights,
                                     epochs, lr, eps, backward)
    metrics = metrics.cpu().numpy()
    return ({s: _unflatten_params(_run_params(out, i)) for i, s in enumerate(seeds)},
            {s: _history(metrics[i]) for i, s in enumerate(seeds)})


def fused_step_reference(params: Params, windows, eps, lr=1e-3,
                         weights: LossWeights = LossWeights(),
                         cfg: Optional[CVAEConfig] = None):
    """One Adam step with explicit ε by autograd of :func:`_forward_loss` —
    the oracle K1 is held against (fused_trainer.py:795)."""
    if cfg is None:
        cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    plist0 = _flatten_params(params)
    x_flat, start = fused_inputs(windows, plist0[0].device)
    plist = [a.detach().clone().requires_grad_(True) for a in plist0]
    eps = torch.as_tensor(eps, dtype=torch.float32, device=x_flat.device)
    total, comps = _forward_loss(plist, x_flat, start, eps, cfg, weights)
    grads = torch.autograd.grad(total, plist)
    new = []
    with torch.no_grad():
        for p, g in zip(plist, grads):
            m = (1 - _B1) * g
            v = (1 - _B2) * g * g
            new.append(p - lr * ((m / (1 - _B1)) / (torch.sqrt(v / (1 - _B2)) + _ADAM_EPS)))
    return _unflatten_params(new), comps.detach()
