"""The benchmark's inputs, made from the run's seed on the host with a
torch generator (the same seed gives the same windows on any machine).

- :func:`scale_corpus`: production-scale ``[t, x, y]`` windows with the
  reference's coordinate scales (the law of the root ``bench.py``'s
  ``_scale_corpus``: time steps U(0.5, 2.2) s from 0; x and y random walks
  with steps N(-193, 1) and N(50, 20)).
- :func:`random_walks`: unit-step ``[x, y]`` walks whose heading turns by
  U(±max_angle) degrees a step, from the origin (the law of the port's
  ``data.generate_random_trajectories``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def scale_corpus(n: int, seed: int, seq_len: int = 10) -> np.ndarray:
    g = torch.Generator().manual_seed(int(seed))
    dt = torch.rand((n, seq_len), generator=g, dtype=torch.float64) * 1.7 + 0.5
    t = torch.cumsum(dt, dim=1)
    t = t - t[:, :1]
    steps = torch.randn((n, seq_len, 2), generator=g, dtype=torch.float64)
    steps = steps * torch.tensor([1.0, 20.0], dtype=torch.float64) \
        + torch.tensor([-193.0, 50.0], dtype=torch.float64)
    xy = torch.cumsum(steps, dim=1)
    return torch.cat([t[..., None], xy], dim=-1).to(torch.float32).numpy()


def random_walks(n: int, seq_len: int, seed: int, max_angle_deg: float = 5.0) -> np.ndarray:
    g = torch.Generator().manual_seed(int(seed))
    max_rad = math.radians(max_angle_deg)
    dtheta = (torch.rand((n, seq_len - 1), generator=g, dtype=torch.float64) * 2 - 1) * max_rad
    ang = torch.cumsum(dtheta, dim=1)
    steps = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    out = torch.zeros((n, seq_len, 2), dtype=torch.float64)
    out[:, 1:] = torch.cumsum(steps, dim=1)
    return out.to(torch.float32).numpy()
