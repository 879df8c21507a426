"""Hand-written backward of the CVAE loss — plain torch.

Port of ``defensive_model_vae_tpu/ops/manual_grad.py``
(``manual_value_and_grad`` :65), its float32 path and its ``f32_acts``
mixed mode.  It is the plain version of the backward of kernels K1, K3 and
K4 and the written specification of the CUDA backward in
``csrc/fused_trainer.cu`` and ``csrc/fused_scale.cu``, which follow it
phase by phase:

- the μ/logσ² head is merged into one (2H, 2Z) weight, so its forward,
  dW and d_hcat products are each one product;
- the recon/start/time cotangents are fused into one d_recon;
- no gradients are taken for the inputs x, cond or ε.

``compute_dtype="bfloat16"`` is the JAX ``f32_acts`` mode: the two operands
of every product — forward, activation gradient and weight gradient — are
rounded to bf16 (round to nearest even) and the product accumulates in
float32 (a product of two bf16 values is exact in float32).  The time
differences, the bias gradients (float32 sums of the float32 cotangent),
the μ/logσ² head math and the loss stay float32 and unrounded.  With
``compute_dtype=None`` every rounding is the identity, so the float32 path
is exactly the one K1's plain version has always run.

``chain_cd`` and the ablation levers (``bias_via_dot``, ``dw_mode``,
``grads_mode``) serve only the JAX ablation script and come with its port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models import CVAEConfig, LossWeights
from .fused_trainer import _LAYERS

_ENC = _LAYERS[2:6]
_DEC = _LAYERS[8:12]


def manual_value_and_grad(plist: List[torch.Tensor], x_flat: torch.Tensor,
                          cond: torch.Tensor, eps: torch.Tensor,
                          cfg: CVAEConfig, w: LossWeights,
                          mask: Optional[torch.Tensor] = None,
                          n_valid: Optional[float] = None,
                          compute_dtype: Optional[str] = None,
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Forward loss + parameter gradients.

    Returns ``(comps, grads)``: ``comps`` the (5,) row ``[total, recon,
    kld, start, time]`` and ``grads`` in ``plist``'s flat ``_LAYERS``
    layout ``[W, b(1, -1), ...]`` — what autograd of
    ``fused_trainer._forward_loss`` returns, up to summation order.
    ``compute_dtype``: None (float32) or ``"bfloat16"`` (the ``f32_acts``
    mode, module docstring)."""
    if compute_dtype is None:
        def dc(a):
            return a
    elif compute_dtype == "bfloat16":
        def dc(a):  # a product operand, rounded to bf16 and held in float32
            return a.to(torch.bfloat16).float()
    else:
        raise ValueError(f"compute_dtype must be None or 'bfloat16' (got {compute_dtype!r})")

    def fdot(a, w):  # forward product
        return dc(a) @ dc(w)

    def ddot_act(dy, w):  # dy · wᵀ
        return dc(dy) @ dc(w).t()

    def ddot_w(a, dy):  # aᵀ · dy
        return dc(a).t() @ dc(dy)

    T, D, Z, H = cfg.seq_len, cfg.dim, cfg.latent_dim, cfg.hidden_dim
    F = T * D
    p = {n: (plist[2 * i], plist[2 * i + 1]) for i, n in enumerate(_LAYERS)}
    x = x_flat.float()
    cond = cond.float()
    eps = eps.float()
    B = x.shape[0]

    # ---- forward (saves post-relu activations) --------------------------
    c0 = torch.relu(fdot(cond, p["cond_0"][0]) + p["cond_0"][1])
    hc = torch.relu(fdot(c0, p["cond_1"][0]) + p["cond_1"][1])
    enc_in = []
    h = x
    for name in _ENC:
        enc_in.append(h)
        h = torch.relu(fdot(h, p[name][0]) + p[name][1])
    hcat = torch.cat([h, hc], dim=1)
    w_ml = torch.cat([p["fc_mu"][0], p["fc_logvar"][0]], dim=1)
    b_ml = torch.cat([p["fc_mu"][1], p["fc_logvar"][1]], dim=1)
    ml = fdot(hcat, w_ml) + b_ml
    mu, logvar = ml[:, :Z], ml[:, Z:]
    std = torch.exp(0.5 * logvar)
    z = mu + eps * std
    gin = torch.cat([z, hc], dim=1)
    dec_in = [gin]
    g = gin
    for name in _DEC[:3]:
        g = torch.relu(fdot(g, p[name][0]) + p[name][1])
        dec_in.append(g)
    recon = fdot(g, p["dec_3"][0]) + p["dec_3"][1]

    # ---- loss ------------------------------------------------------------
    if mask is None:
        m_col = torch.ones((B, 1), dtype=torch.float32, device=x.device)
        denom = torch.tensor(float(B), dtype=torch.float32, device=x.device)
    else:
        m_col = mask if mask.ndim == 2 else mask[:, None]
        denom = (torch.clamp(torch.sum(m_col), min=1.0) if n_valid is None
                 else torch.tensor(float(n_valid), dtype=torch.float32,
                                   device=x.device))

    def mean_rows(arr):
        return torch.sum(arr * m_col) / (denom * arr.shape[1])

    t_diffs = recon[:, D::D] - recon[:, 0:F - D:D]  # (B, T-1)
    recon_loss = mean_rows((recon - x) ** 2)
    kld = -0.5 * mean_rows(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    start_loss = mean_rows((recon[:, 1:3] - x[:, 1:3]) ** 2)
    time_loss = mean_rows(recon[:, 0:1] ** 2) + mean_rows(torch.relu(-t_diffs))
    total = (w.recon * recon_loss + w.kld * kld
             + w.start * start_loss + w.time * time_loss)
    comps = torch.stack([total, recon_loss, kld, start_loss, time_loss])

    # ---- backward ----------------------------------------------------------
    S = 1.0 / denom
    col = torch.arange(F, device=x.device)[None, :]
    start_cols = ((col == 1) | (col == 2)).float()
    t0_col = (col == 0).float()
    # d max(-t, 0)/dt = -1 where t < 0
    d_tdiff = (-w.time * S / (T - 1)) * m_col * (t_diffs < 0).float()
    d_recon = m_col * (
        (recon - x) * (w.recon * 2.0 * S / F + w.start * S * start_cols)
        + recon * (w.time * 2.0 * S * t0_col)
    )
    # the (F, T-1) ±1 difference matrix, transposed: +d at t_{i+1}, -d at t_i
    d_recon[:, D::D] += d_tdiff
    d_recon[:, 0:F - D:D] -= d_tdiff

    grads = {}

    def back_linear(name, a_in, dy):
        grads[name] = (ddot_w(a_in, dy), torch.sum(dy, dim=0, keepdim=True))
        return ddot_act(dy, p[name][0])

    dy = d_recon
    for i in (3, 2, 1, 0):
        d_prev = back_linear(_DEC[i], dec_in[i], dy)
        if i > 0:
            dy = d_prev * (dec_in[i] > 0).float()
    dz, dhc_dec = d_prev[:, :Z], d_prev[:, Z:]

    # heads: dμ = dz + wk·S/Z·m·μ;  dlogσ² = dz·ε·σ/2 − wk·S/(2Z)·m·(1−e^lv)
    kS = w.kld * S / Z
    d_mu = dz + kS * m_col * mu
    d_logvar = dz * eps * (0.5 * std) - (0.5 * kS) * m_col * (1.0 - torch.exp(logvar))
    d_ml = torch.cat([d_mu, d_logvar], dim=1)
    dw_ml = ddot_w(hcat, d_ml)
    db_ml = torch.sum(d_ml, dim=0, keepdim=True)
    grads["fc_mu"] = (dw_ml[:, :Z], db_ml[:, :Z])
    grads["fc_logvar"] = (dw_ml[:, Z:], db_ml[:, Z:])
    d_hcat = ddot_act(d_ml, w_ml)
    dhc = dhc_dec + d_hcat[:, H:]

    enc_out = enc_in[1:] + [h]
    dy = d_hcat[:, :H] * (enc_out[3] > 0).float()
    for i in (3, 2, 1):
        d_prev = back_linear(_ENC[i], enc_in[i], dy)
        dy = d_prev * (enc_out[i - 1] > 0).float()
    grads["enc_0"] = (ddot_w(enc_in[0], dy), torch.sum(dy, dim=0, keepdim=True))

    dy = dhc * (hc > 0).float()
    d_c0 = back_linear("cond_1", c0, dy)
    dy = d_c0 * (c0 > 0).float()
    grads["cond_0"] = (ddot_w(cond, dy), torch.sum(dy, dim=0, keepdim=True))

    flat = []
    for name in _LAYERS:
        flat.extend(grads[name])
    return comps, flat
