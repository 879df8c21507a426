"""The benchmark's yardstick: operations and bytes from shapes, and the
card's peaks.

Frozen here so that a change to the program cannot move it.  The dense
CVAE's counts are ``chip_smoke.py``'s (``window_epoch_flops``,
``scale_flops_bytes``, ``bound``) as they stood when the benchmark was
defined; the Conv1D VAE's and the serve program's are written from the
algorithm, not from the kernels that run it.  Two FLOP a multiply-add.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W limit
PEAKS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12

# Adam's operations per parameter a step (moments, bias corrections, update)
ADAM_FLOPS_PER_PARAM = 10


def cvae_layers(cfg: dict) -> dict:
    """The dense CVAE's layers as (in, out), forward order."""
    H, Z, T, D, C = (cfg["hidden_dim"], cfg["latent_dim"], cfg["seq_len"], cfg["dim"],
                     cfg["cond_dim"])
    return {"cond_0": (C, H), "cond_1": (H, H),
            "enc_0": (T * D, H), "enc_1": (H, H), "enc_2": (H, H), "enc_3": (H, H),
            "fc_mu": (2 * H, Z), "fc_logvar": (2 * H, Z),
            "dec_0": (Z + H, H), "dec_1": (H, H), "dec_2": (H, H), "dec_3": (H, T * D)}


def cvae_params(cfg: dict) -> int:
    return sum(i * o + o for i, o in cvae_layers(cfg).values())


def cvae_window_epoch_flops(cfg: dict) -> int:
    """One window in one epoch: the forward, the weight gradients and the
    activation gradients (none for the inputs of cond_0 and enc_0)."""
    spec = cvae_layers(cfg)
    mac = sum(i * o for i, o in spec.values())
    mac_da = mac - sum(spec[n][0] * spec[n][1] for n in ("cond_0", "enc_0"))
    return 2 * (2 * mac + mac_da)


def cvae_job_flops(cfg: dict, rows: int, epochs: int) -> int:
    """A training job: every epoch's products over ``rows`` windows and Adam."""
    return epochs * (rows * cvae_window_epoch_flops(cfg)
                     + ADAM_FLOPS_PER_PARAM * cvae_params(cfg))


def k3_flops_bytes(cfg: dict, rows: int, epochs: int, itemsize: int,
                   eps_stream: bool = True):
    """K3's work for a job: the products and Adam; the bytes of the corpus
    ([x | cond | mask]) and of the ε stream, each read once, the params in
    and out and the metrics."""
    n_params = cvae_params(cfg)
    width = cfg["seq_len"] * cfg["dim"] + cfg["cond_dim"] + 1
    flops = cvae_job_flops(cfg, rows, epochs)
    nbytes = (itemsize * rows * (width + (epochs * cfg["latent_dim"] if eps_stream else 0))
              + 4 * (2 * n_params + 8 * epochs))
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: operations at ``peak`` or bytes
    at the HBM rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


# ---- the temporal Conv1D VAE --------------------------------------------------

def _down(L: int) -> int:
    return (L + 1) // 2


def conv_lengths(cfg: dict):
    """(encoder input lengths, bottleneck length, decoder output lengths)."""
    L, ins = cfg["seq_len"], []
    for _ in cfg["channels"]:
        ins.append(L)
        L = _down(L)
    return ins, L, list(reversed(ins))


def _deconv_taps(L_in: int, L_out: int, K: int, stride: int = 2) -> int:
    """Multiply-adds per (input channel, output channel) of a stride-2
    "SAME" transposed conv cropped to ``L_out``: the taps of each output
    position that land on a real (not inserted) input point."""
    pad_lo = K - 1 if stride > K - 1 else -(-(K + stride - 2) // 2)
    taps = 0
    for t in range(L_out):
        for k in range(K):
            q = t + k - pad_lo  # position in the dilated input
            if q >= 0 and q % stride == 0 and q // stride < L_in:
                taps += 1
    return taps


def conv_forward_macs(cfg: dict) -> dict:
    """Each layer's multiply-adds for one window's forward pass."""
    K, H, Z, C = cfg["kernel"], cfg["hidden_dim"], cfg["latent_dim"], cfg["cond_dim"]
    ch = list(cfg["channels"])
    ins, Lb, outs = conv_lengths(cfg)
    macs, cin = {}, cfg["dim"]
    for i, c in enumerate(ch):
        macs[f"conv_{i}"] = _down(ins[i]) * K * cin * c
        cin = c
    flat = Lb * ch[-1]
    macs.update({"enc_proj": flat * H, "cond_0": C * H, "cond_1": H * H,
                 "fc_mu": 2 * H * Z, "fc_logvar": 2 * H * Z, "dec_proj": (Z + H) * flat})
    cin, L_in = ch[-1], Lb
    for i, c in enumerate(list(reversed(ch[:-1])) + [cfg["dim"]]):
        macs[f"deconv_{i}"] = _deconv_taps(L_in, outs[i], K) * cin * c
        cin, L_in = c, outs[i]
    return macs


def conv_params(cfg: dict) -> int:
    K, H, Z, C = cfg["kernel"], cfg["hidden_dim"], cfg["latent_dim"], cfg["cond_dim"]
    ch = list(cfg["channels"])
    _, Lb, _ = conv_lengths(cfg)
    n, cin = 0, cfg["dim"]
    for c in ch:
        n += K * cin * c + c
        cin = c
    flat = Lb * ch[-1]
    n += flat * H + H + C * H + H + H * H + H + 2 * (2 * H * Z + Z) + (Z + H) * flat + flat
    cin = ch[-1]
    for c in list(reversed(ch[:-1])) + [cfg["dim"]]:
        n += K * cin * c + c
        cin = c
    return n


def conv_window_epoch_flops(cfg: dict) -> int:
    """One window in one epoch: forward, weight gradients and activation
    gradients (none for the inputs of conv_0 and cond_0)."""
    macs = conv_forward_macs(cfg)
    total = sum(macs.values())
    return 2 * (2 * total + total - macs["conv_0"] - macs["cond_0"])


def conv_job_flops(cfg: dict, rows: int, epochs: int) -> int:
    return epochs * (rows * conv_window_epoch_flops(cfg)
                     + ADAM_FLOPS_PER_PARAM * conv_params(cfg))


def train_mfu(counters: dict, config: dict, window_s: float):
    """The traced training jobs' model FLOPs (from the shapes) over the
    traced window, in % of the configuration's peak times the chips used;
    None where no job was traced."""
    if not counters.get("jobs"):
        return None
    job = (conv_job_flops if config["family"] == "conv_cvae" else cvae_job_flops)(
        config, counters["rows"], counters["job_epochs"])
    peak = PEAKS[config["peak"]] * counters.get("chips", 1)
    return percent(counters["jobs"] * job / (window_s * peak))


# ---- the serve program ----------------------------------------------------------

def lm_iteration_flops(P: int, M: int) -> int:
    """One Levenberg–Marquardt iteration of one row at horizons (P, M):
    the Jacobian's three held products, JᵀJ and Jᵀr over its R = 2(P+1) + 2M
    rows, and the order-2M solve (2n³/3 + 2n²)."""
    R, n = 2 * (P + 1) + 2 * M, 2 * M
    jac = 3 * 2 * (P + 1) * P * M
    normal = 2 * n * n * R + 2 * n * R
    solve = 2 * n ** 3 / 3 + 2 * n ** 2
    return int(jac + normal + solve)


def lu_flops_bytes(rows: int, n: int):
    """The batched order-n solve: operations, and the bytes of H, g and x."""
    return rows * (2 * n ** 3 / 3 + 2 * n ** 2), rows * (n * n + 2 * n) * 4


def serve_request_flops(model: dict, batch: int, draws: int, steps: int, P: int, M: int,
                        lm_iters: int) -> int:
    """A /serve request: the decoder on batch × draws candidates, then
    ``steps`` tracker steps of ``lm_iters`` LM iterations a row."""
    spec = cvae_layers(model)
    dec = sum(spec[n][0] * spec[n][1] for n in ("cond_0", "cond_1", "dec_0", "dec_1",
                                                 "dec_2", "dec_3"))
    return int(2 * dec * batch * draws
               + steps * lm_iters * batch * lm_iteration_flops(P, M))


def percent(x: float) -> float:
    if not math.isfinite(x):
        raise ValueError(f"not a finite share: {x}")
    return 100.0 * x
