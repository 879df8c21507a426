"""Import and export the reference's torch checkpoints (``.pth`` state_dicts).

Port of ``defensive_model_vae_tpu/train/torch_import.py``
(``load_torch_checkpoint`` :51, ``import_to_checkpoint`` :96,
``export_to_pth`` :139): the reference's shipped ``vae*.pth`` files
(naming ``vae[_offset]_<sce>[_cond]_ld<Z>_epoch<E>.pth``) load into the
port's params, and a checkpoint trained here exports back to that format.
Here both directions are native torch: ``torch.load(weights_only=True)``
and ``torch.save`` of plain float32 tensors.

Layer mapping (reference ``Training_VAE.ConditionalTrajectoryVAE``,
``:118-167``, the Linear layers' sequential indices):

    condition_encoder.0/.2      → cond_0 / cond_1
    encoder.1/.3/.5/.7          → enc_0..enc_3
    fc_mu / fc_logvar           → fc_mu / fc_logvar
    decoder.0/.2/.4/.6          → dec_0..dec_3

torch's Linear stores its weight (out, in); the params' is (in, out).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import CVAEConfig
from ..models.cvae import Params
from .checkpoint import load_checkpoint, params_from_numpy, params_to_numpy, save_checkpoint

_NAME_MAP = {
    "condition_encoder.0": "cond_0",
    "condition_encoder.2": "cond_1",
    "encoder.1": "enc_0",
    "encoder.3": "enc_1",
    "encoder.5": "enc_2",
    "encoder.7": "enc_3",
    "fc_mu": "fc_mu",
    "fc_logvar": "fc_logvar",
    "decoder.0": "dec_0",
    "decoder.2": "dec_1",
    "decoder.4": "dec_2",
    "decoder.6": "dec_3",
}


def load_torch_checkpoint(path: str, dim: Optional[int] = None,
                          device="cuda") -> Tuple[Params, CVAEConfig]:
    """A reference ``.pth`` state_dict → (params on ``device``, config).

    ``dim`` disambiguates the flattened window width: the state_dict only
    shows ``seq_len * dim``, and a width divisible by 3 is taken as dim 3
    ([t, x, y], every shipped ``vae*_<sce>`` checkpoint) unless ``dim`` is
    given (JAX :51-93)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    tree = {}
    for torch_name, ours in _NAME_MAP.items():
        w = state[f"{torch_name}.weight"].numpy()
        b = state[f"{torch_name}.bias"].numpy()
        tree[ours] = {"w": np.ascontiguousarray(w.T, np.float32),
                      "b": np.asarray(b, np.float32)}
    flat = tree["enc_0"]["w"].shape[0]
    if flat != tree["dec_3"]["w"].shape[1]:
        raise ValueError("encoder and decoder widths disagree")
    if dim is None:
        dim = 3 if flat % 3 == 0 else 2
    elif flat % dim:
        raise ValueError(f"flat width {flat} is not divisible by requested dim={dim}")
    cfg = CVAEConfig(seq_len=flat // dim, dim=dim,
                     latent_dim=tree["fc_mu"]["w"].shape[1],
                     hidden_dim=tree["cond_0"]["w"].shape[1],
                     cond_dim=tree["cond_0"]["w"].shape[0])
    return params_from_numpy(tree, device), cfg


def _scenario_pattern() -> str:
    """The registry's keys, longest first, anchored at digit boundaries: an
    unregistered 'sce10' matches nothing rather than the registered 'sce1'."""
    from .. import scenarios

    keys = sorted(scenarios.REGISTRY, key=len, reverse=True)
    return r"(?<!\d)(?:" + "|".join(re.escape(k) for k in keys) + r")(?!\d)"


def import_to_checkpoint(pth_path: str, out_dir: str, dim: Optional[int] = None,
                         device="cuda") -> str:
    """Convert a ``.pth`` into a checkpoint directory (JAX :96).

    The reference encodes the coordinate mode in the file name: ``vae_offset_*``
    models decode relative [t, dx, dy], plain ``vae_*`` ones absolute
    [t, x, y]; it is recorded as ``offset_mode`` in the manifest.  The offset
    marker and the scenario are read from the basename only, never from the
    directories above it."""
    params, cfg = load_torch_checkpoint(pth_path, dim=dim, device=device)
    base = os.path.basename(str(pth_path))
    m = re.search(_scenario_pattern(), base)
    return save_checkpoint(out_dir, params, cfg, m.group(0) if m else None,
                           extra_manifest={"imported_from": str(pth_path),
                                           "offset_mode": "offset" in base})


def export_to_pth(ckpt_dir: str, pth_path: str) -> str:
    """Write a checkpoint directory as a reference-format ``.pth`` (JAX :139),
    the inverse of :func:`import_to_checkpoint`: weights transposed back to
    (out, in), plain float32 tensors, so it loads under
    ``torch.load(weights_only=True)`` and strictly into the reference's
    ``ConditionalTrajectoryVAE``.  Only the MLP family exports: a Conv1D
    checkpoint has no reference class, and is refused."""
    params, _, _ = load_checkpoint(ckpt_dir, device="cpu")
    missing = [ours for ours in _NAME_MAP.values() if ours not in params]
    if missing:
        raise ValueError(
            f"checkpoint {ckpt_dir!r} is not a reference-family MLP CVAE "
            f"(missing layers {missing}); only models/cvae.py checkpoints "
            "export to the reference .pth format"
        )
    tree = params_to_numpy(params)
    state = {}
    for torch_name, ours in _NAME_MAP.items():
        state[f"{torch_name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(tree[ours]["w"].astype(np.float32).T))
        state[f"{torch_name}.bias"] = torch.from_numpy(
            tree[ours]["b"].astype(np.float32).copy())
    torch.save(state, pth_path)
    return str(pth_path)
