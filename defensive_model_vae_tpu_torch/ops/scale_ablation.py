"""The K3 ablation's own kernels (P1, P2) and their plain versions.

Port of the Pallas kernels of the JAX package's ablation script
``scripts/scale_ablation.py`` (``_ablation_call`` :207, with
``_make_stream_kernel`` :182, ``_make_sol_kernel`` :148 and
``_make_ablation_kernel`` :94) and of the probe
``scripts/noise_consumer_probe.py`` (``_stream_kernel`` :78, ``gen_stream``
:94).  On the card P1-sol is ``csrc/p1_sol.cu`` (``wgmma`` on the tensor
cores, the chain kept in registers) and the others ``csrc/scale_ablation.cu``,
which shares K3's device code (``csrc/scale_common.cuh``); their design
notes give each kernel's bound.  Every function here takes a packed bf16 corpus
``(n_pad, width)`` as ``ops/fused_scale._pack_corpus`` makes it and returns
an ``(epochs, 8)`` metrics block, one row per epoch, as the JAX grid does
(JAX pads the rows to a multiple of 8; the port does not):

- :func:`p1_stream` — per epoch the float32 sum of the whole block, in
  column 0;
- :func:`p1_sol` — per tile ``h = x·W_in`` then ``n_chain`` products
  ``h·W`` with bf16 operands and float32 accumulation, no relu; sum(h) in
  column 0;
- :func:`p1_ablation` — ``mode="fwd"``: the loss components of
  ``_forward_loss`` (``f32_acts``, packed ε, global ``n_valid``) in columns
  0–4; ``mode="dx"``: those and, in column 5, the float32 sum of the
  gradient of the total loss in the bf16 x;
- :func:`p2_stream_sum` — a (rows, 8) ε stream summed into one (1, 8) row
  holding the total in every lane.

On CUDA tensors each launches its kernel (counted in ``.launches``; P1-abl
also by mode, in ``.mode_launches``) or raises; on CPU tensors it runs its
plain version.  The plain versions are vectorised over the tiles: the
tile-ordered sums of the JAX grid are the same sums in another order, and
every row of P1's results is independent of how the rows are tiled.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import CVAEConfig, LossWeights
from .fused_trainer import _forward_loss, pack_kernel_params

P1_MODES = {"fwd": 0, "dx": 1}
_KERNEL_CFG = CVAEConfig()


def sol_chain_length(cfg: CVAEConfig) -> int:
    """The sol variant's chain: as many 128×128 products as make the
    entry product plus the chain cost what K3's training does a window
    (6·Σ fi·fo), as JAX :266-271 computes it."""
    sum_fifo = sum(fi * fo for fi, fo in cfg.layer_spec().values())
    width = cfg.seq_len * cfg.dim + cfg.cond_dim + 1 + cfg.latent_dim
    return round((6 * sum_fifo - 2 * width * 128) / (2 * 128 * 128))


def _check_packed(packed, name):
    if packed.ndim != 2 or packed.dtype != torch.bfloat16 or not packed.is_contiguous():
        raise ValueError(f"{name}: the corpus must be a contiguous 2-D bf16 tensor "
                         f"(got {tuple(packed.shape)} {packed.dtype})")


def _check_tile(n_pad, tile, name):
    if tile <= 0 or n_pad % tile:
        raise ValueError(f"{name}: {n_pad} rows are not a multiple of tile={tile}")


def _device_of(t, name):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or (plain) CPU tensors, got {dev}")
    return dev


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev) -> int:
    # the handle of PyTorch's current stream on a tensor's device: what
    # torch.cuda.current_stream(dev).cuda_stream reads, without building a
    # Stream object (ops/cache_decoy.py takes the same route)
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _lib():
    from ._build import load

    return load("scale_ablation")


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


_LAUNCH_KINDS = ("stream", "fwd", "dx", "p2")


def cuda_launches() -> dict:
    """The CUDA kernel launches each entry of ``csrc/scale_ablation.cu`` and
    ``csrc/p1_sol.cu`` has issued in this process, counted by the C code at
    each launch (P1-abl by mode)."""
    from ._build import _LOADED

    lib = _lib()
    out = {k: int(lib.sa_cuda_launches(i)) for i, k in enumerate(_LAUNCH_KINDS)}
    # a P1-sol library not loaded in this process has launched nothing
    sol = _LOADED.get("p1_sol")
    out["sol"] = int(sol.p1_sol_cuda_launches()) if sol is not None else 0
    return out


# ---- P1-stream ------------------------------------------------------------------

def _p1_stream_plain(packed, epochs, tile):
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=packed.device)
    for e in range(epochs):
        tiles = packed.reshape(packed.shape[0] // tile, -1).float().sum(dim=1)
        metrics[e, 0] = tiles.sum()
    return metrics


# P1-stream's workspace, by (device index, stream handle): its block
# partials (an epoch's row of them per epoch), its tickets (one an epoch,
# zeroed once, here, on that stream; the kernel leaves them 0) and its grid;
# grown to the most epochs a call has asked for.
_P1S_WS: dict = {}


def _p1s_workspace(lib, dev, stream, epochs):
    ws = _P1S_WS.get((dev.index, stream))
    if ws is None or ws[1].numel() < epochs:
        grid = int(lib.p1_stream_grid(_sms(dev)))
        ws = (torch.empty(epochs * grid, dtype=torch.float32, device=dev),
              torch.zeros(epochs, dtype=torch.int32, device=dev), grid)
        _P1S_WS[(dev.index, stream)] = ws
    return ws


def p1_stream(packed: torch.Tensor, epochs: int, tile: int) -> torch.Tensor:
    """Per epoch the float32 sum of the packed block (JAX
    ``_make_stream_kernel``), every epoch in one launch."""
    _check_packed(packed, "P1-stream")
    _check_tile(packed.shape[0], tile, "P1-stream")
    if _device_of(packed, "P1-stream").type == "cpu":
        return _p1_stream_plain(packed, epochs, tile)
    lib, dev = _lib(), packed.device
    stream = _stream(dev)
    partial, ticket, grid = _p1s_workspace(lib, dev, stream, epochs)
    # every lane of every row is written by the kernel
    metrics = torch.empty((epochs, 8), dtype=torch.float32, device=dev)
    _check(lib.p1_stream(packed.data_ptr(), packed.numel(), epochs, partial.data_ptr(),
                         ticket.data_ptr(), grid, metrics.data_ptr(), stream), "P1-stream")
    p1_stream.launches += 1
    return metrics


p1_stream.launches = 0


# ---- P1-sol -----------------------------------------------------------------------

def _sol_h(packed, w_in, w_chain, n_chain):
    """The chain's last h over every row: bf16 operands, float32 sums."""
    h = packed.float() @ w_in.float()
    for _ in range(n_chain):
        h = h.to(torch.bfloat16).float() @ w_chain.float()
    return h


def _p1_sol_plain(packed, w_in, w_chain, n_chain, epochs, tile):
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=packed.device)
    for e in range(epochs):
        h = _sol_h(packed, w_in, w_chain, n_chain)
        metrics[e, 0] = h.reshape(packed.shape[0] // tile, -1).sum(dim=1).sum()
    return metrics


# the widest corpus the kernel's entry product takes (one 64-deep k atom)
SOL_MAX_WIDTH = 64
# id of a loaded P1-sol library -> its SASS's HGMMA count, read at its first
# call (the library path's key hashes the sources: not once a launch)
_SOL_HGMMA: dict = {}


def _sol_lib():
    """The P1-sol library, refused unless its SASS holds HGMMA (its products
    on wgmma): the kernel has no other path on the card."""
    from ._build import _lib_path, load, tensor_core_ops

    lib = load("p1_sol")
    if id(lib) not in _SOL_HGMMA:
        _SOL_HGMMA[id(lib)] = tensor_core_ops(_lib_path("p1_sol"))["HGMMA"]
    if not _SOL_HGMMA[id(lib)]:
        raise RuntimeError("the p1_sol library's SASS holds no HGMMA")
    return lib


def p1_sol(packed: torch.Tensor, w_in: torch.Tensor, w_chain: torch.Tensor,
           n_chain: int, epochs: int, tile: int) -> torch.Tensor:
    """Per epoch the FLOP-equivalent chained products over the block, sum(h)
    in column 0 (JAX ``_make_sol_kernel``).  ``w_in`` (width, 128) and
    ``w_chain`` (128, 128) are bf16; the width is at most 64."""
    _check_packed(packed, "P1-sol")
    _check_tile(packed.shape[0], tile, "P1-sol")
    width = packed.shape[1]
    if (tuple(w_in.shape) != (width, 128) or tuple(w_chain.shape) != (128, 128)
            or w_in.dtype != torch.bfloat16 or w_chain.dtype != torch.bfloat16):
        raise ValueError(f"P1-sol: w_in must be ({width}, 128) and w_chain (128, 128), "
                         f"both bf16")
    if width > SOL_MAX_WIDTH or n_chain < 0 or epochs < 1:
        raise ValueError(f"P1-sol: width {width} (at most {SOL_MAX_WIDTH}), n_chain "
                         f"{n_chain} (at least 0) or epochs {epochs} (at least 1) refused")
    dev = _device_of(packed, "P1-sol")
    if w_in.device != dev or w_chain.device != dev:
        raise ValueError("P1-sol: the corpus and the weights must be on one device")
    if dev.type == "cpu":
        return _p1_sol_plain(packed, w_in, w_chain, n_chain, epochs, tile)
    if packed.data_ptr() % 16:
        raise ValueError("P1-sol: the corpus must start on a 16-byte boundary")
    lib = _sol_lib()
    grid = int(lib.p1_sol_grid(_sms(dev), width))
    if grid <= 0:
        raise RuntimeError("P1-sol: no grid for this card (p1_sol_grid)")
    partial = torch.empty(epochs * int(lib.p1_sol_partials(grid)), dtype=torch.float32,
                          device=dev)
    metrics = torch.empty((epochs, 8), dtype=torch.float32, device=dev)
    wi, wc = w_in.contiguous(), w_chain.contiguous()
    _check(lib.p1_sol(packed.data_ptr(), width, packed.shape[0], wi.data_ptr(),
                      wc.data_ptr(), n_chain, epochs, partial.data_ptr(), grid,
                      metrics.data_ptr(), _stream(dev)), "P1-sol")
    p1_sol.launches += 1
    return metrics


p1_sol.launches = 0


# ---- P1-abl -------------------------------------------------------------------------

def _split(packed, cfg):
    F, C, Z = cfg.seq_len * cfg.dim, cfg.cond_dim, cfg.latent_dim
    return (packed[:, :F], packed[:, F:F + C], packed[:, F + C:F + C + 1].float(),
            packed[:, F + C + 1:F + C + 1 + Z])


def _dx_plain(packed, plist, cfg, weights, n_valid, with_comps=False):
    """∂total/∂x by autograd of ``_forward_loss`` (bf16 ``f32_acts``), x
    the bf16 leaf: a bf16 (n_pad, F) tensor (and the loss components)."""
    x, cond, mask, eps = _split(packed, cfg)
    xv = x.detach().clone().requires_grad_(True)
    total, comps = _forward_loss(plist, xv, cond, eps, cfg, weights, mask,
                                 n_valid=n_valid, compute_dtype="bfloat16")
    (gx,) = torch.autograd.grad(total, xv)
    return (gx, comps.detach()) if with_comps else gx


def _p1_ablation_plain(packed, plist, mode, cfg, weights, n_valid, epochs):
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=packed.device)
    x, cond, mask, eps = _split(packed, cfg)
    for e in range(epochs):
        if mode == "fwd":
            with torch.no_grad():
                _, comps = _forward_loss(plist, x, cond, eps, cfg, weights, mask,
                                         n_valid=n_valid, compute_dtype="bfloat16")
            metrics[e, :5] = comps
            continue
        gx, comps = _dx_plain(packed, plist, cfg, weights, n_valid, with_comps=True)
        metrics[e, :5] = comps
        metrics[e, 5] = gx.float().sum()
    return metrics


def p1_ablation(packed: torch.Tensor, plist, mode: str, cfg: CVAEConfig,
                weights: LossWeights, n_valid: float, epochs: int,
                tile: int) -> torch.Tensor:
    """Per epoch the loss components under the fixed ``plist`` (packed ε,
    bf16 ``f32_acts`` products), and under ``mode="dx"`` the float32 sum of
    ∂total/∂x, x a bf16 leaf (JAX ``_make_ablation_kernel``)."""
    if mode not in P1_MODES:
        raise ValueError(f"mode must be one of {sorted(P1_MODES)} (got {mode!r})")
    _check_packed(packed, "P1-abl")
    _check_tile(packed.shape[0], tile, "P1-abl")
    want = cfg.seq_len * cfg.dim + cfg.cond_dim + 1 + cfg.latent_dim
    if packed.shape[1] != want:
        raise ValueError(f"P1-abl: the corpus needs its {want} packed-ε columns "
                         f"(got {packed.shape[1]})")
    if _device_of(packed, "P1-abl").type == "cpu":
        return _p1_ablation_plain(packed, plist, mode, cfg, weights, n_valid, epochs)
    if cfg != _KERNEL_CFG:
        raise ValueError(f"P1-abl: compiled for {_KERNEL_CFG}, got {cfg}")
    lib, dev = _lib(), packed.device
    params = pack_kernel_params(plist)
    if params.numel() != lib.sa_param_floats() or params.device != dev:
        raise ValueError("P1-abl: parameter list does not match the compiled model")
    partial = torch.empty(int(lib.sa_chunks(packed.shape[0], _sms(dev))) * 8,
                          dtype=torch.float32, device=dev)
    metrics = torch.zeros((epochs, 8), dtype=torch.float32, device=dev)
    _check(lib.p1_ablation(
        packed.data_ptr(), packed.shape[1], packed.shape[0], ctypes.c_float(n_valid),
        P1_MODES[mode], ctypes.c_float(weights.recon), ctypes.c_float(weights.kld),
        ctypes.c_float(weights.start), ctypes.c_float(weights.time), params.data_ptr(),
        epochs, partial.data_ptr(), _sms(dev), metrics.data_ptr(), _stream(dev)),
        f"P1-abl ({mode})")
    p1_ablation.launches += 1
    p1_ablation.mode_launches[mode] += 1
    return metrics


p1_ablation.launches = 0
p1_ablation.mode_launches = dict.fromkeys(P1_MODES, 0)


# ---- P2 -----------------------------------------------------------------------------

def _p2_plain(eps, tile):
    total = eps.reshape(eps.shape[0] // tile, -1).float().sum(dim=1).sum()
    return total.reshape(1, 1).expand(1, 8).contiguous()


# P2's workspace, by (device index, stream handle): its block partials, its
# ticket (zeroed once, here, on that stream; the kernel's last block resets
# it) and its grid.  One per stream, so calls on two streams never share it.
_P2_WS: dict = {}


def _p2_workspace(lib, dev, stream):
    grid = int(lib.p2_grid(_sms(dev)))
    ws = (torch.empty(grid, dtype=torch.float32, device=dev),
          torch.zeros(1, dtype=torch.int32, device=dev), grid)
    _P2_WS[(dev.index, stream)] = ws
    return ws


def p2_stream_sum(eps: torch.Tensor, tile: int = 2048) -> torch.Tensor:
    """The (rows, Z) bf16 ε stream summed into a (1, 8) row, the total in
    every lane (JAX ``noise_consumer_probe._stream_kernel``), in one launch."""
    _check_packed(eps, "P2")
    _check_tile(eps.shape[0], tile, "P2")
    dev = _device_of(eps, "P2")
    if dev.type == "cpu":
        return _p2_plain(eps, tile)
    lib = _lib()
    stream = _stream(dev)
    partial, ticket, grid = _P2_WS.get((dev.index, stream)) or _p2_workspace(lib, dev, stream)
    out = torch.empty((1, 8), dtype=torch.float32, device=dev)
    _check(lib.p2_stream_sum(eps.data_ptr(), eps.numel(), partial.data_ptr(), ticket.data_ptr(),
                             grid, out.data_ptr(), stream), "P2")
    p2_stream_sum.launches += 1
    return out


p2_stream_sum.launches = 0
