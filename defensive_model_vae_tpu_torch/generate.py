"""Trajectory generation.

Port of ``defensive_model_vae_tpu/generate.py`` (``generate_trajectories``
:36, the legacy ``shift_start=False`` decoder :28-33): sample z ~ N(0, I),
condition on the absolute start point, decode a relative [t, dx, dy]
trajectory and shift it to global [t, x, y] — batched over start points
and samples.  z is drawn from a CPU ``torch.Generator`` seeded with
``seed``, so a seed gives the same trajectories on every device; ``z``
feeds explicit draws instead (the tests pass the z the JAX side drew).
:func:`make_generate_fn` is the server's batched sampler, its draws made on
the device from a counter-based stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models import CVAEConfig, sample
from .train.checkpoint import load_checkpoint, require_cvae_config


def generate_trajectories(params, cfg: CVAEConfig, start_xy: np.ndarray,
                          n_samples: int = 1, seed: int = 0,
                          shift_start: bool = True,
                          z: Optional[np.ndarray] = None) -> np.ndarray:
    """``n_samples`` global [t, x, y] trajectories per start point, on the
    device the params live on.

    Args:
        start_xy: (B, 2) or (2,) start coordinates.
        z: optional (B·n_samples, Z) latent draws, row b·n + i for start b.

    Returns (B, n_samples, T, D) numpy, squeezed to (T, D) for B = n = 1."""
    dev = params["dec_3"]["w"].device
    start_xy = np.atleast_2d(np.asarray(start_xy, np.float32))
    B = start_xy.shape[0]
    tiled = torch.as_tensor(np.repeat(start_xy, n_samples, axis=0)).to(dev)
    gen = None
    if z is None:
        gen = torch.Generator().manual_seed(int(seed))
    else:
        z = torch.as_tensor(np.asarray(z, np.float32))
    with torch.no_grad():
        out = sample(params, gen, tiled, cfg, z=z, shift_start=shift_start)
    out = out.cpu().numpy().reshape(B, n_samples, cfg.seq_len, cfg.dim)
    if B == 1 and n_samples == 1:
        return out[0, 0]
    return out


def make_generate_fn(params, cfg: CVAEConfig, offset_mode: bool = True, mesh=None):
    """The batched device sampler behind the server's ``/generate`` (JAX
    ``generate._sample_jit`` as ``serving._generate_fn_from`` uses it), on
    the device the params live on.

    Returns ``gen(seed, start_xy, z=None) → (B, T, D)`` global [t, x, y]
    trajectories as a device tensor.  Row b's z is row b of the seed's
    Philox stream (``control.device_reference.request_draws``, one draw a
    row), so a row's draw depends only on (seed, b); ``z`` (B, Z) feeds
    explicit draws.  ``offset_mode=False`` is the legacy non-offset
    decoder.  ``mesh`` splits the batch over the data axis as the serve
    program does (``control.device_reference.make_serve_fn``): the whole
    batch's draws on every rank, a block of rows each, gathered to every
    rank, a failed block failing the call on every rank."""
    from .control.device_reference import _as_f32, request_draws

    if mesh is not None:
        from .parallel.mesh import check_mesh

        check_mesh(mesh)
    dev = params["dec_3"]["w"].device

    def gen(seed, start_xy, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mesh is None:
            return _gen_batch(seed, start_xy, z)
        from .parallel.mesh import gather_rows, run_block

        return gather_rows(run_block(lambda: _gen_batch(seed, start_xy, z), mesh), mesh)

    def _gen_batch(seed, start_xy, z):
        """The batch's rows (with a mesh, this rank's block of them)."""
        starts = _as_f32(start_xy, dev)
        if z is None:
            z = request_draws(seed, starts.shape[0], 1, cfg.latent_dim, dev)[:, 0]
        z = _as_f32(z, dev)
        if mesh is not None:
            from .parallel.mesh import block

            if starts.shape[0] % mesh.shape["data"]:
                raise ValueError(f"batch {starts.shape[0]} is not a multiple of the "
                                 f"{mesh.shape['data']}-rank data axis")
            rows = block(starts.shape[0], mesh)
            starts, z = starts[rows], z[rows]
        with torch.inference_mode():
            return sample(params, None, starts, cfg, z=z, shift_start=offset_mode)

    return gen


def load_and_generate(checkpoint_dir: str, start_x: float, start_y: float,
                      n_samples: int = 1, seed: int = 0, device="cuda") -> np.ndarray:
    """Checkpoint-path convenience (generate.py:74); honours the manifest's
    ``offset_mode``."""
    params, cfg, manifest = load_checkpoint(checkpoint_dir, device)
    require_cvae_config(cfg, "load_and_generate")
    return generate_trajectories(params, cfg, np.array([start_x, start_y]),
                                 n_samples, seed,
                                 shift_start=manifest.get("offset_mode", True))
