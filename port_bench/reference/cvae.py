"""The dense conditional VAE's training job, plain PyTorch.

The model of yslf2035/Defensive-Model-VAE ``Training_VAE.py:124-167``: a
condition encoder (start point → 2 × 128, relu), an encoder over the
flattened relative window (4 × 128, relu), μ and log σ² heads over both,
z = μ + ε·exp(log σ²/2), a decoder over [z, condition] (3 × 128, relu, then
linear to the window).  The loss: weighted mean squared reconstruction,
KL, start-point and time-order terms (weights 0.1, 0.1, 1, 1), each a mean
over rows and columns.  Full-batch Adam (lr 1e-3, 0.9, 0.999, 1e-8).

The benchmark's job, as the harness hands it to both sides:

- the windows, relative to their first point, with the start point as the
  condition, stored in the configuration's dtype;
- the initial weights: U(±1/√fan_in) for weight and bias, layer by layer
  in forward order (weight, then bias), from a CPU ``torch.Generator``
  seeded with the job's seed;
- ε: every epoch's (rows, latent) standard normals drawn at once, flat, by
  a ``torch.Generator`` on the device seeded with
  ``SeedSequence([seed, 1]).generate_state(1, uint64)``, and stored in the
  configuration's dtype, epoch-major.

Every product takes its operands rounded to ``fmt`` (``rounding.py``),
accumulates in float32 and adds a float32 bias; weights, Adam and the loss
stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rounding import rounder

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
LAYERS = ("cond_0", "cond_1", "enc_0", "enc_1", "enc_2", "enc_3", "fc_mu", "fc_logvar",
          "dec_0", "dec_1", "dec_2", "dec_3")
STORE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layer_shapes(cfg: dict):
    H, Z, T, D, C = (cfg["hidden_dim"], cfg["latent_dim"], cfg["seq_len"], cfg["dim"],
                     cfg["cond_dim"])
    return [(C, H), (H, H), (T * D, H), (H, H), (H, H), (H, H), (2 * H, Z), (2 * H, Z),
            (Z + H, H), (H, H), (H, H), (H, T * D)]


def init_leaves(seed: int, cfg: dict, device) -> list:
    g = torch.Generator().manual_seed(int(seed))
    leaves = []
    for fi, fo in layer_shapes(cfg):
        bound = 1.0 / math.sqrt(fi)
        w = (torch.rand((fi, fo), generator=g) * 2.0 - 1.0) * bound
        b = (torch.rand((fo,), generator=g) * 2.0 - 1.0) * bound
        leaves += [w.to(device), b.to(device)]
    return leaves


def noise_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(stream)])
               .generate_state(1, np.uint64)[0])


def draw_noise(seed: int, stream: int, shape, store, device) -> torch.Tensor:
    """Standard normals of ``shape`` from stream ``stream`` of ``seed`` on
    ``device``, rounded to the stored dtype and held in float32."""
    g = torch.Generator(device=device)
    g.manual_seed(noise_seed(seed, stream))
    n = math.prod(shape)
    eps = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    return eps.to(STORE[store]).to(torch.float32).reshape(shape)


def job_inputs(windows: np.ndarray, store: str, device):
    """(relative flat windows, start points), rounded to the stored dtype."""
    w = torch.as_tensor(np.asarray(windows, np.float32)).to(device)
    start = w[:, 0, 1:3].clone()
    rel = w.clone()
    rel[:, :, 1:3] -= start[:, None, :]
    x = rel.reshape(w.shape[0], -1)
    rd = lambda a: a.to(STORE[store]).to(torch.float32)  # noqa: E731
    return rd(x), rd(start)


def loss(leaves, x, cond, eps, cfg: dict, weights: dict, q):
    """The total loss and its four terms."""
    p = {n: (leaves[2 * i], leaves[2 * i + 1]) for i, n in enumerate(LAYERS)}

    def lin(name, h):
        w, b = p[name]
        return q(h) @ q(w) + b

    hc = torch.relu(lin("cond_1", torch.relu(lin("cond_0", cond))))
    h = x
    for name in ("enc_0", "enc_1", "enc_2", "enc_3"):
        h = torch.relu(lin(name, h))
    hcat = torch.cat([h, hc], dim=1)
    mu, logvar = lin("fc_mu", hcat), lin("fc_logvar", hcat)
    z = mu + eps * torch.exp(0.5 * logvar)
    g = torch.cat([z, hc], dim=1)
    for name in ("dec_0", "dec_1", "dec_2"):
        g = torch.relu(lin(name, g))
    recon = lin("dec_3", g)
    T, D = cfg["seq_len"], cfg["dim"]
    recon_l = torch.mean((recon - x) ** 2)
    kld = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    start_l = torch.mean((recon[:, 1:3] - x[:, 1:3]) ** 2)
    t_col = recon[:, 0::D][:, :T]
    time_l = torch.mean(recon[:, 0] ** 2) + torch.mean(torch.relu(-(t_col[:, 1:] - t_col[:, :-1])))
    total = (weights["recon"] * recon_l + weights["kld"] * kld + weights["start"] * start_l
             + weights["time"] * time_l)
    return total


def adam(leaves, grads, m, v, t: int, lr: float):
    bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    out = []
    for i, (p, g) in enumerate(zip(leaves, grads)):
        m[i] = B1 * m[i] + (1 - B1) * g
        v[i] = B2 * v[i] + (1 - B2) * g * g
        out.append(p - lr * ((m[i] / bc1) / (torch.sqrt(v[i] / bc2) + ADAM_EPS)))
    return out


def train_job(windows: np.ndarray, seed: int, epochs: int, cfg: dict, fmt: str,
              store: str, device, run_epochs: int = None):
    """A job of ``epochs`` epochs (its ε drawn for all of them), followed
    for its first ``run_epochs`` (default all) on ``device`` → {"init",
    "final": leaves, "losses": (run_epochs,) float64, "grad0": the first
    epoch's gradient norm a leaf}."""
    q = rounder(fmt)
    x, cond = job_inputs(windows, store, device)
    n, Z = x.shape[0], cfg["latent_dim"]
    eps_all = draw_noise(seed, 1, (epochs, n, Z), store, device)
    leaves = init_leaves(seed, cfg, device)
    init = [a.clone() for a in leaves]
    m = [torch.zeros_like(a) for a in leaves]
    v = [torch.zeros_like(a) for a in leaves]
    losses, grad0 = [], None
    for e in range(epochs if run_epochs is None else run_epochs):
        ps = [a.detach().requires_grad_(True) for a in leaves]
        total = loss(ps, x, cond, eps_all[e], cfg, cfg["loss_weights"], q)
        grads = torch.autograd.grad(total, ps)
        if grad0 is None:
            grad0 = [float(torch.linalg.vector_norm(g)) for g in grads]
        losses.append(float(total.detach()))
        with torch.no_grad():
            leaves = adam([a.detach() for a in leaves], grads, m, v, e + 1, cfg["lr"])
    return {"init": init, "final": leaves, "losses": np.array(losses), "grad0": grad0}
