"""The temporal Conv1D VAE's training job (BASELINE config 3), plain PyTorch.

The model over [x, y] windows relative to their first point, conditioned
on the start point: three stride-2 "SAME" convolutions (kernel 5, 32/64/128
channels, relu), a linear projection of the time-major flattened
bottleneck to 128 (relu), the condition encoder (2 × 128, relu), μ and
log σ² heads over both, z = μ + ε·exp(log σ²/2), a linear projection of
[z, condition] back to the bottleneck (relu), and three stride-2 "SAME"
transposed convolutions (kernel unflipped, as ``lax.conv_transpose``
computes them: the input dilated by the stride, padded (⌈(K+s−2)/2⌉,
K+s−2−⌈(K+s−2)/2⌉), correlated with the kernel, cropped to the encoder's
lengths), relu between them.  Loss: mean squared reconstruction + 0.05 ×
the mean KL term; full-batch Adam (lr 1e-3, 0.9, 0.999, 1e-8, bias
correction in float32).

The job as the harness hands it to both sides: the windows; the initial
weights U(±1/√fan_in) (fan_in = K·C_in for a convolution) for weight and
bias, layer by layer (``layer_shapes``' order, weight then bias), from a
CPU ``torch.Generator`` seeded with the job's seed; epoch e's ε, (rows,
latent) standard normals from a CPU generator seeded with
(seed·0x9E3779B97F4A7C15 + e·0xBF58476D1CE4E5B9 + 1) mod 2⁶³.

Convolutions are written as unfolded windows contracted with the kernel
(``einsum``), so no convolution library enters the reference.  Products
are float32; the caller sets TF32 (off for the reference, on for the
control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def lengths(cfg: dict):
    L, ins = cfg["seq_len"], []
    for _ in cfg["channels"]:
        ins.append(L)
        L = (L + 1) // 2
    return ins, L, list(reversed(ins))


def layer_shapes(cfg: dict):
    """(name, weight shape) in the order the weights are drawn."""
    K, H, Z, C = cfg["kernel"], cfg["hidden_dim"], cfg["latent_dim"], cfg["cond_dim"]
    ch = list(cfg["channels"])
    _, Lb, _ = lengths(cfg)
    out, cin = [], cfg["dim"]
    for i, c in enumerate(ch):
        out.append((f"conv_{i}", (K, cin, c)))
        cin = c
    flat = Lb * ch[-1]
    out += [("enc_proj", (flat, H)), ("cond_0", (C, H)), ("cond_1", (H, H)),
            ("fc_mu", (2 * H, Z)), ("fc_logvar", (2 * H, Z)), ("dec_proj", (Z + H, flat))]
    cin = ch[-1]
    for i, c in enumerate(list(reversed(ch[:-1])) + [cfg["dim"]]):
        out.append((f"deconv_{i}", (K, cin, c)))
        cin = c
    return out


def init_leaves(seed: int, cfg: dict, device) -> list:
    g = torch.Generator().manual_seed(int(seed))
    leaves = []
    for _, shape in layer_shapes(cfg):
        fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound
        b = (torch.rand((shape[-1],), generator=g) * 2.0 - 1.0) * bound
        leaves += [w.to(device), b.to(device)]
    return leaves


def epoch_noise(seed: int, epoch: int, shape) -> torch.Tensor:
    s = (int(seed) * 0x9E3779B97F4A7C15 + int(epoch) * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)
    return torch.randn(shape, generator=torch.Generator().manual_seed(s))


def conv(x, w, b, stride: int = 2):
    """(B, L, Cin) → (B, ⌈L/stride⌉, Cout), "SAME" padding."""
    K, L = w.shape[0], x.shape[1]
    out = -(-L // stride)
    total = max((out - 1) * stride + K - L, 0)
    xp = torch.nn.functional.pad(x, (0, 0, total // 2, total - total // 2))
    patches = xp.unfold(1, K, stride)              # (B, out, Cin, K)
    return torch.einsum("bock,kcd->bod", patches, w) + b


def deconv(x, w, b, out_len: int, stride: int = 2):
    """(B, L, Cin) → (B, out_len, Cout): the stride-dilated input, padded
    and correlated with the unflipped kernel."""
    K = w.shape[0]
    B, L, C = x.shape
    xd = x.new_zeros((B, (L - 1) * stride + 1, C))
    xd[:, ::stride] = x
    lo = K - 1 if stride > K - 1 else -(-(K + stride - 2) // 2)
    xp = torch.nn.functional.pad(xd, (0, 0, lo, K + stride - 2 - lo))
    patches = xp.unfold(1, K, 1)                    # (B, 2L, Cin, K)
    return (torch.einsum("bock,kcd->bod", patches, w) + b)[:, :out_len]


def loss(leaves, x, cond, eps, cfg: dict):
    p = {name: (leaves[2 * i], leaves[2 * i + 1])
         for i, (name, _) in enumerate(layer_shapes(cfg))}
    lin = lambda n, h: h @ p[n][0] + p[n][1]  # noqa: E731
    ch = list(cfg["channels"])
    _, Lb, outs = lengths(cfg)
    h = x
    for i in range(len(ch)):
        h = torch.relu(conv(h, *p[f"conv_{i}"]))
    h = torch.relu(lin("enc_proj", h.reshape(h.shape[0], -1)))
    hc = torch.relu(lin("cond_1", torch.relu(lin("cond_0", cond))))
    hcat = torch.cat([h, hc], dim=1)
    mu, logvar = lin("fc_mu", hcat), lin("fc_logvar", hcat)
    z = mu + torch.exp(0.5 * logvar) * eps
    g = torch.relu(lin("dec_proj", torch.cat([z, hc], dim=1))).reshape(-1, Lb, ch[-1])
    for i, L in enumerate(outs):
        g = deconv(g, *p[f"deconv_{i}"], L)
        if i < len(outs) - 1:
            g = torch.relu(g)
    recon_l = torch.mean((g - x) ** 2)
    kld = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return recon_l + cfg["kld_weight"] * kld


def adam(leaves, grads, m, v, t: int, lr: float):
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(t))
    out = []
    for i, (p, g) in enumerate(zip(leaves, grads)):
        m[i] = B1 * m[i] + (1 - B1) * g
        v[i] = B2 * v[i] + (1 - B2) * g * g
        out.append(p - lr * ((m[i] / bc1) / (torch.sqrt(v[i] / bc2) + ADAM_EPS)))
    return out


def train_job(windows: np.ndarray, seed: int, cfg: dict, run_epochs: int, device) -> dict:
    """The job's first ``run_epochs`` epochs → {"init", "final", "losses",
    "grad0"} as the dense CVAE's reference returns them."""
    w = torch.as_tensor(np.asarray(windows, np.float32)).to(device)
    start = w[:, 0, :2]
    x = w - start[:, None, :]
    cond = torch.nn.functional.pad(start, (0, cfg["cond_dim"] - start.shape[1]))
    leaves = init_leaves(seed, cfg, device)
    init = [a.clone() for a in leaves]
    m = [torch.zeros_like(a) for a in leaves]
    v = [torch.zeros_like(a) for a in leaves]
    losses, grad0 = [], None
    for e in range(run_epochs):
        eps = epoch_noise(seed, e, (x.shape[0], cfg["latent_dim"])).to(device)
        ps = [a.detach().requires_grad_(True) for a in leaves]
        total = loss(ps, x, cond, eps, cfg)
        grads = torch.autograd.grad(total, ps)
        if grad0 is None:
            grad0 = [float(torch.linalg.vector_norm(g)) for g in grads]
        losses.append(float(total.detach()))
        with torch.no_grad():
            leaves = adam([a.detach() for a in leaves], grads, m, v, e + 1, cfg["lr"])
    return {"init": init, "final": leaves, "losses": np.array(losses), "grad0": grad0}
