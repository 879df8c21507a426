"""Checkpoints in the JAX package's format, and params to and from numpy.

Port of ``defensive_model_vae_tpu/train/checkpoint.py`` (``save_checkpoint``
:50, ``load_checkpoint`` :114, ``require_cvae_config`` :149): a checkpoint is
a directory holding

- ``params.npz``    — ``"<layer>/w"`` (in, out) and ``"<layer>/b"`` (out,)
- ``manifest.json`` — model config, scenario key and metadata
- ``history.npz``   — the loss curves, when given

so the committed ``results/checkpoints/sce*/`` load unchanged, and a
checkpoint written here loads in the JAX package.  The Orbax backend and
the Conv1D configs come with later slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models import CVAEConfig
from ..ops.fused_trainer import _LAYERS

NumpyParams = Dict[str, Dict[str, np.ndarray]]


def params_from_numpy(flat: Union[NumpyParams, Sequence[np.ndarray]],
                      device="cuda", stacked: bool = False):
    """The JAX package's params as numpy — ``{layer: {"w", "b"}}`` or the
    flat ``_LAYERS`` list ``[W, b, ...]`` (b may be (1, out)) — → the port's
    float32 params on ``device``.

    ``stacked=True`` takes every array with a leading run axis, (S, in, out)
    and (S, [1,] out) — JAX's per-scenario or per-seed init, as
    ``fused_train_multi`` stacks it or ``_stacked_init`` returns it — and
    gives the list of the S runs' params."""
    dev = resolve_device(device)
    if not isinstance(flat, dict):
        flat = list(flat)
        if len(flat) != 2 * len(_LAYERS):
            raise ValueError(f"expected {2 * len(_LAYERS)} arrays, got {len(flat)}")
        flat = {n: {"w": flat[2 * i], "b": flat[2 * i + 1]}
                for i, n in enumerate(_LAYERS)}
    if stacked:
        runs = len(flat[_LAYERS[0]]["w"])
        return [params_from_numpy({n: {k: np.asarray(a)[s] for k, a in layer.items()}
                                   for n, layer in flat.items()}, dev)
                for s in range(runs)]
    return {
        name: {
            "w": torch.as_tensor(np.array(layer["w"], np.float32)).to(dev),
            "b": torch.as_tensor(np.array(layer["b"], np.float32).reshape(-1)).to(dev),
        }
        for name, layer in flat.items()
    }


def params_to_numpy(params) -> NumpyParams:
    """Inverse of :func:`params_from_numpy`: ``{layer: {"w", "b"}}`` numpy."""
    return {name: {k: a.detach().cpu().numpy() for k, a in layer.items()}
            for name, layer in params.items()}


def save_checkpoint(directory: str, params, model_cfg: CVAEConfig,
                    scenario: Optional[str] = None,
                    history: Optional[Dict[str, np.ndarray]] = None,
                    extra_manifest: Optional[Dict[str, Any]] = None) -> str:
    """Save params (+ manifest, + history) under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    flat = {f"{name}/{k}": a for name, layer in params_to_numpy(params).items()
            for k, a in layer.items()}
    np.savez(os.path.join(directory, "params.npz"), **flat)
    manifest = {
        "format_version": 1,
        "model_config": dataclasses.asdict(model_cfg),
        "scenario": scenario,
        "backend": "npz",
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    hist_path = os.path.join(directory, "history.npz")
    if history is not None:
        np.savez(hist_path, **{k: np.asarray(v) for k, v in history.items()})
    elif os.path.exists(hist_path):
        # a previous run's loss curves must not be attributed to new weights
        os.remove(hist_path)
    return directory


def load_checkpoint(directory: str, device="cuda") -> Tuple[Dict, Any, Dict[str, Any]]:
    """→ (params on ``device``, model config, manifest)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    backend = manifest.get("backend", "npz")
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r} is not supported by the port")
    tree: NumpyParams = {}
    with np.load(os.path.join(directory, "params.npz")) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    mc = dict(manifest["model_config"])
    model_cfg: Any = mc if "channels" in mc else CVAEConfig(**mc)
    return params_from_numpy(tree, device), model_cfg, manifest


def require_cvae_config(model_cfg, purpose: str) -> CVAEConfig:
    """Fail at the boundary when a checkpoint is not an MLP CVAE (a Conv1D
    checkpoint's config is returned as its raw manifest dict)."""
    if not isinstance(model_cfg, CVAEConfig):
        raise TypeError(
            f"{purpose} supports the MLP CVAE family only; this checkpoint "
            f"has config {model_cfg!r}"
        )
    return model_cfg

