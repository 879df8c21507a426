"""Full-batch CVAE trainers (the CLI's default, scan-trainer tier).

Port of ``defensive_model_vae_tpu/train/train.py`` (``TrainConfig`` :36,
``train`` :125, ``train_conditioned`` :206, ``train_multi_scenario``
:229): every epoch is the absolute→relative transform, the CVAE forward
with fresh reparameterization noise, the four-term loss, its gradient
(autograd), and one Adam step with optax's defaults (b1 0.9, b2 0.999, eps
1e-8).  The JAX trainer folds the GLOBAL epoch index into its key; here
epoch e's noise comes from a CPU ``torch.Generator`` seeded with a fold of
(seed, e), so a run resumed at ``start_epoch`` continues the noise stream
and chunked training equals one long run.

``TrainConfig.compute_dtype="bfloat16"`` is JAX's bf16 chain: params,
inputs and noise are cast to bf16 for the forward and backward (the casts'
backward brings the gradients back to float32 against float32 masters),
recon, mu and logvar go up to float32 for the loss, whose reductions and
Adam stay float32.  These trainers are plain torch in real bf16 tensors;
on the card cuBLAS may not reduce bf16 products in reduced precision
(``allow_bf16_reduced_precision_reduction`` is held False while they run).

``train_conv`` (:297) trains the temporal-conv VAE (``models/conv_cvae.py``,
BASELINE config 3) the same way: full batch, one autograd pass and one Adam
step an epoch.  The mesh comes with a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig, LossWeights, cvae_loss, init_params, to_relative
from ..models.conv_cvae import (ConvCVAEConfig, conv_forward, init_conv_params,
                                pad_condition)
from ..models.cvae import decode, encode

_METRIC_KEYS = ("total", "recon", "kld", "start", "time")
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # defaults = reference training config (train.py:36-50)
    epochs: int = 3000
    lr: float = 1e-3
    weights: LossWeights = LossWeights()
    seed: int = 0
    # mixed precision: None (pure float32) or "bfloat16" (the bf16 chain
    # with float32 loss reductions and float32 masters)
    compute_dtype: Optional[str] = None


def _epoch_seed(seed: int, epoch: int) -> int:
    """The per-epoch generator seed: a fold of (seed, global epoch)."""
    return (seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def epoch_noise(seed: int, epoch: int, shape) -> torch.Tensor:
    """The reparameterization noise of one epoch (CPU float32)."""
    g = torch.Generator().manual_seed(_epoch_seed(seed, epoch))
    return torch.randn(shape, generator=g)


def _torch_dtype(compute_dtype):
    if compute_dtype is None:
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or 'bfloat16' (got {compute_dtype!r})")


@contextlib.contextmanager
def _exact_bf16_reductions():
    """bf16 products accumulate in float32 (as XLA's do) while this runs."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _model_loss(params, x_rel, cond, eps, cfg: CVAEConfig, train_cfg: TrainConfig,
                mask=None):
    """JAX ``make_train_step``'s loss_fn (train.py:61-86) with explicit
    noise: (total, components).  Under a compute dtype the params, inputs
    and noise are cast down and recon, mu and logvar back up; the loss's
    target is the float32 relative batch."""
    dt = _torch_dtype(train_cfg.compute_dtype)
    p, x, c = params, x_rel, cond
    if dt is not None:
        p = {k: {n: a.to(dt) for n, a in v.items()} for k, v in params.items()}
        x, c, eps = x.to(dt), c.to(dt), eps.to(dt)
    mu, logvar, hc = encode(p, x, c)
    z = mu + eps * torch.exp(0.5 * logvar)
    recon = decode(p, z, hc, cfg)
    if dt is not None:
        recon, mu, logvar = recon.float(), mu.float(), logvar.float()
    return cvae_loss(recon, x_rel, mu, logvar, train_cfg.weights, mask)


def _adam(leaves, grads, m, v, count, lr):
    """One Adam step (optax's defaults, bias correction 1 - b**count in
    float32) over lists of tensors → (new leaves, m, v)."""
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
    out_p, out_m, out_v = [], [], []
    with torch.no_grad():
        for p, g, mi, vi in zip(leaves, grads, m, v):
            mi = _B1 * mi + (1 - _B1) * g
            vi = _B2 * vi + (1 - _B2) * g * g
            out_p.append(p.detach() - lr * ((mi / bc1) / (torch.sqrt(vi / bc2) + _ADAM_EPS)))
            out_m.append(mi)
            out_v.append(vi)
    return out_p, out_m, out_v


def _noise(eps, seed: int, start_epoch: int, E: int, shape, dev) -> torch.Tensor:
    """(E, *shape) noise: the given ``eps`` ((E, *shape), or ``shape`` held
    over the epochs) or the per-epoch generator stream of ``seed``."""
    if eps is not None:
        e = torch.as_tensor(np.asarray(eps, np.float32)).to(dev)
        return e.expand((E,) + tuple(shape)) if e.ndim == len(shape) else e
    return torch.stack([epoch_noise(seed, start_epoch + e, shape)
                        for e in range(E)]).to(dev)


def train(windows: np.ndarray, model_cfg: Optional[CVAEConfig] = None,
          train_cfg: TrainConfig = TrainConfig(),
          extra_cond: Optional[np.ndarray] = None,
          init_state: Optional[Tuple[Dict, Dict]] = None,
          return_state: bool = False, start_epoch: int = 0,
          eps=None, device="cuda"):
    """Train one scenario model on its full window corpus.

    Args:
        windows: (N, T, D) absolute [t, x, y] windows.
        extra_cond: optional (N, k) extra condition features appended to
            the start point (the conditioned variant, cond_dim = 2 + k).
        init_state: optional (params, opt_state) to resume from; opt_state
            is ``{"count": int, "m": {...}, "v": {...}}`` as returned with
            ``return_state``.
        start_epoch: epochs already trained when resuming (selects the
            noise of the global epoch index).
        eps: optional explicit noise, (epochs, N, Z) or (N, Z) held over the
            epochs, in place of the generator stream.

    Returns (params, history) — plus opt_state when ``return_state``."""
    dev = resolve_device(device)
    if model_cfg is None:
        cond_dim = 2 + (0 if extra_cond is None else np.asarray(extra_cond).shape[1])
        model_cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2],
                               cond_dim=cond_dim)
    batch = torch.as_tensor(np.asarray(windows, np.float32)).to(dev)
    x_rel, cond = to_relative(batch)
    if extra_cond is not None:
        cond = torch.cat([cond, torch.as_tensor(np.asarray(extra_cond, np.float32))
                          .to(dev)], dim=1)
    if init_state is not None:
        params, opt_state = init_state
        params = {k: {n: a.detach().clone().to(dev) for n, a in v.items()}
                  for k, v in params.items()}
        count = int(opt_state["count"])
        m = {k: {n: a.clone().to(dev) for n, a in v.items()} for k, v in opt_state["m"].items()}
        v_ = {k: {n: a.clone().to(dev) for n, a in v.items()} for k, v in opt_state["v"].items()}
    else:
        params = init_params(torch.Generator().manual_seed(train_cfg.seed), model_cfg, dev)
        count = 0
        m = {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()}
        v_ = {k: {n: torch.zeros_like(a) for n, a in v.items()} for k, v in params.items()}

    E, B, Z = train_cfg.epochs, batch.shape[0], model_cfg.latent_dim
    noise = _noise(eps, train_cfg.seed, start_epoch, E, (B, Z), dev) if E else None
    leaves = [(k, n) for k in params for n in ("w", "b")]
    metrics = torch.zeros((E, 5), dtype=torch.float32, device=dev)
    with _exact_bf16_reductions():
        for e in range(E):
            plist = [params[k][n].requires_grad_(True) for k, n in leaves]
            total, comps = _model_loss(params, x_rel, cond, noise[e], model_cfg, train_cfg)
            grads = torch.autograd.grad(total, plist)
            count += 1
            new_p, new_m, new_v = _adam(plist, grads, [m[k][n] for k, n in leaves],
                                        [v_[k][n] for k, n in leaves], count,
                                        train_cfg.lr)
            for (k, n), p, mi, vi in zip(leaves, new_p, new_m, new_v):
                params[k][n], m[k][n], v_[k][n] = p, mi, vi
            metrics[e] = torch.stack([comps[key].detach() for key in _METRIC_KEYS])
    metrics = metrics.cpu().numpy()
    history = {k: metrics[:, i] for i, k in enumerate(_METRIC_KEYS)}
    if return_state:
        return params, history, {"count": count, "m": m, "v": v_}
    return params, history


def train_conditioned(windows: np.ndarray, extra_cond: np.ndarray,
                      train_cfg: TrainConfig = TrainConfig(), eps=None,
                      device="cuda") -> Tuple[Dict, Dict[str, np.ndarray], CVAEConfig]:
    """Train the scenario-class/THW-conditioned variant: the condition is
    [start_x, start_y, extra...] (cond_dim = 2 + k).  A thin wrapper over
    :func:`train`, as JAX's (train.py:206).  → (params, history, config)."""
    model_cfg = CVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2],
                           cond_dim=2 + np.asarray(extra_cond).shape[1])
    params, history = train(windows, model_cfg, train_cfg, extra_cond=extra_cond,
                            eps=eps, device=device)
    return params, history, model_cfg


# ---- all scenarios at once, over a leading model axis --------------------------

def train_multi_scenario(windows_by_scenario: Dict[str, np.ndarray],
                         train_cfg: TrainConfig = TrainConfig(),
                         params_by_scenario: Optional[Dict[str, Dict]] = None,
                         eps=None, device="cuda"):
    """Train every scenario's model in one pass per epoch (train.py:229).

    Corpora are padded to the largest N with copies of their first row and
    a sample mask (JAX :245-254); the S models' params carry a leading
    model axis, so each epoch is one batched forward, one backward and one
    Adam step over all of them.  Model i (keys in the given order) starts
    from ``init_params`` of seed ``seed + i`` and draws the noise stream of
    seed ``seed + i``, unless ``params_by_scenario`` ({key: params}) or
    ``eps`` ((epochs, S, N_max, Z)) is given.  → ({key: params},
    {key: history})."""
    dev = resolve_device(device)
    keys = list(windows_by_scenario)
    first = windows_by_scenario[keys[0]]
    cfg = CVAEConfig(seq_len=first.shape[1], dim=first.shape[2])
    n_max = max(w.shape[0] for w in windows_by_scenario.values())
    batches, masks = [], []
    for k in keys:
        w = np.asarray(windows_by_scenario[k], np.float32)
        pad = n_max - w.shape[0]
        batches.append(np.concatenate([w, np.repeat(w[:1], pad, 0)], axis=0))
        masks.append(np.concatenate([np.ones(w.shape[0]), np.zeros(pad)]))
    batch = torch.as_tensor(np.stack(batches)).to(dev)               # (S, N, T, D)
    mask = torch.as_tensor(np.stack(masks), dtype=torch.float32).to(dev)
    S = len(keys)
    rel, start = to_relative(batch.reshape(S * n_max, *batch.shape[2:]))
    x_rel, cond = rel.reshape(batch.shape), start.reshape(S, n_max, 2)
    if params_by_scenario is None:
        per = [init_params(torch.Generator().manual_seed(train_cfg.seed + i), cfg, dev)
               for i in range(S)]
    else:
        per = [params_by_scenario[k] for k in keys]
    params = {layer: {n: torch.stack([p[layer][n] for p in per]).to(dev)
                      for n in ("w", "b")} for layer in per[0]}
    E, Z = train_cfg.epochs, cfg.latent_dim
    if eps is None:
        noise = torch.stack([_noise(None, train_cfg.seed + i, 0, E, (n_max, Z), dev)
                             for i in range(S)], dim=1)              # (E, S, N, Z)
    else:
        noise = torch.as_tensor(np.asarray(eps, np.float32)).to(dev)
    leaves = [(k, n) for k in params for n in ("w", "b")]
    m = [torch.zeros_like(params[k][n]) for k, n in leaves]
    v = [torch.zeros_like(params[k][n]) for k, n in leaves]
    metrics = torch.zeros((E, S, 5), dtype=torch.float32, device=dev)
    # _model_loss over the leading model axis: S models' masked losses in one
    # batched pass → ((S,) totals, (S, 5) components)
    batched = torch.func.vmap(
        lambda p, x, c, z, mk: _model_loss(p, x, c, z, cfg, train_cfg, mk))

    def stacked_loss(p, x, c, z, mk):
        total, comps = batched(p, x, c, z, mk)
        return total, torch.stack([comps[key] for key in _METRIC_KEYS], dim=1)

    with _exact_bf16_reductions():
        for e in range(E):
            plist = [params[k][n].requires_grad_(True) for k, n in leaves]
            totals, comps = stacked_loss(params, x_rel, cond, noise[e], mask)
            # the models share no parameter: the gradient of the sum is each one's own
            grads = torch.autograd.grad(totals.sum(), plist)
            new_p, m, v = _adam(plist, grads, m, v, e + 1, train_cfg.lr)
            for (k, n), p in zip(leaves, new_p):
                params[k][n] = p
            metrics[e] = comps.detach()
    metrics = metrics.cpu().numpy()
    params_by = {k: {layer: {n: params[layer][n][i].detach() for n in ("w", "b")}
                     for layer in params} for i, k in enumerate(keys)}
    history_by = {k: {name: metrics[:, i, j] for j, name in enumerate(_METRIC_KEYS)}
                  for i, k in enumerate(keys)}
    return params_by, history_by


# ---- the temporal-conv VAE (BASELINE config 3) -----------------------------

def _as_port_params(params, dev):
    """Port params (torch leaves, cloned onto ``dev``) or the JAX package's
    params as numpy (carried across by ``params_from_numpy``)."""
    from .checkpoint import params_from_numpy

    leaf = next(iter(next(iter(params.values())).values()))
    if isinstance(leaf, torch.Tensor):
        return {k: {n: a.detach().clone().to(dev) for n, a in v.items()}
                for k, v in params.items()}
    return params_from_numpy(params, dev)


def train_conv(windows: np.ndarray, model_cfg: Optional[ConvCVAEConfig] = None,
               train_cfg: TrainConfig = TrainConfig(epochs=500),
               kld_weight: float = 0.05, init_params=None, eps=None,
               device="cuda") -> Tuple[Dict, Dict[str, np.ndarray], ConvCVAEConfig]:
    """Train the temporal-conv VAE on long windows (JAX train.py:297).

    ``windows``: (N, T, D) trajectories, relative targets with the
    absolute-start condition: dim ≥ 3 windows are [t, x, y] and go through
    ``to_relative``; dim 2 windows are [x, y] minus their first point.  The
    condition is zero-padded to ``cond_dim``.  Loss: mean squared
    reconstruction error + ``kld_weight`` · the mean KL term; Adam with
    optax's defaults.

    ``init_params``: the initial params (the port's, or the JAX package's
    as numpy), else ``init_conv_params`` of a generator seeded with
    ``train_cfg.seed``.  ``eps``: the noise, (epochs, N, Z) or (N, Z) held
    over the epochs, else the per-epoch stream ``epoch_noise(seed, e)``.

    Returns (params, history {"total", "recon", "kld"}, model config)."""
    dev = resolve_device(device)
    if model_cfg is None:
        model_cfg = ConvCVAEConfig(seq_len=windows.shape[1], dim=windows.shape[2])
    x_abs = torch.as_tensor(np.asarray(windows, np.float32)).to(dev)
    if x_abs.shape[2] >= 3:
        x, start = to_relative(x_abs)
    else:
        start = x_abs[:, 0, :2]
        x = x_abs - start[:, None, :]
    cond = pad_condition(start, model_cfg)
    if init_params is None:
        params = init_conv_params(torch.Generator().manual_seed(train_cfg.seed),
                                  model_cfg, dev)
    else:
        params = _as_port_params(init_params, dev)

    E, N = train_cfg.epochs, x.shape[0]
    noise = _noise(eps, train_cfg.seed, 0, E, (N, model_cfg.latent_dim), dev) if E else None
    leaves = [(k, n) for k in params for n in ("w", "b")]
    m = [torch.zeros_like(params[k][n]) for k, n in leaves]
    v = [torch.zeros_like(params[k][n]) for k, n in leaves]
    metrics = torch.zeros((E, 3), dtype=torch.float32, device=dev)
    for e in range(E):
        plist = [params[k][n].requires_grad_(True) for k, n in leaves]
        recon, mu, lv, _ = conv_forward(params, None, x, cond, model_cfg, eps=noise[e])
        recon_l = torch.mean((recon - x) ** 2)
        kld = -0.5 * torch.mean(1 + lv - mu ** 2 - torch.exp(lv))
        total = recon_l + kld_weight * kld
        grads = torch.autograd.grad(total, plist)
        new_p, m, v = _adam(plist, grads, m, v, e + 1, train_cfg.lr)
        for (k, n), p in zip(leaves, new_p):
            params[k][n] = p
        metrics[e] = torch.stack([total, recon_l, kld]).detach()
    metrics = metrics.cpu().numpy()
    history = {"total": metrics[:, 0], "recon": metrics[:, 1], "kld": metrics[:, 2]}
    return params, history, model_cfg
