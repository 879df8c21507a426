"""Checkpoints in the JAX package's format, and params to and from numpy.

Port of ``defensive_model_vae_tpu/train/checkpoint.py`` (``save_checkpoint``
:50, ``load_checkpoint`` :114, ``require_cvae_config`` :149,
``save_opt_state`` :165, ``load_opt_state`` :175, ``load_history`` :193): a
checkpoint is a directory holding

- ``params.npz``    — ``"<layer>/w"`` and ``"<layer>/b"`` (a linear layer's
  w is (in, out), a Conv1D layer's (K, Cin, Cout))
- ``manifest.json`` — model config (a ``CVAEConfig``, or a ``ConvCVAEConfig``
  when it has ``channels``), scenario key and metadata
- ``history.npz``   — the loss curves, when given
- ``opt_state.npz`` — Adam's state for resuming, when saved: ``count``,
  ``mu/<layer>/<leaf>``, ``nu/<layer>/<leaf>``

so the committed ``results/checkpoints/sce*/`` load unchanged, and a
checkpoint or optimizer state written by either package loads in the other.

JAX's ``backend="orbax"`` is not ported, and a checkpoint saved with it is
refused with the way to convert it.  Orbax is a format for sharded
``jax.Array`` params, saved asynchronously; the largest params of this
system are 361,938 floats (the Conv1D VAE), one ``params.npz`` of 1.4 MB,
and reading Orbax needs orbax and tensorstore, which the port's machines do
not have.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models import ConvCVAEConfig, CVAEConfig
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


def save_checkpoint(directory: str, params, model_cfg,
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
    """→ (params on ``device``, model config, manifest).  The config is a
    ``CVAEConfig``, or a ``ConvCVAEConfig`` when the manifest has the conv
    fields (JAX :135-144)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    backend = manifest.get("backend", "npz")
    if backend != "npz":
        raise ValueError(
            f"checkpoint backend {backend!r} is not supported by the port (only npz); "
            "convert it: load it with the JAX package's load_checkpoint and save it "
            "again with save_checkpoint(..., backend='npz')")
    tree: NumpyParams = {}
    with np.load(os.path.join(directory, "params.npz")) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    mc = dict(manifest["model_config"])
    if "channels" in mc:
        # a Conv1D checkpoint: JSON stores the channels tuple as a list
        mc["channels"] = tuple(mc["channels"])
        model_cfg: Any = ConvCVAEConfig(**mc)
    else:
        model_cfg = CVAEConfig(**mc)
    return params_from_numpy(tree, device), model_cfg, manifest


def require_cvae_config(model_cfg, purpose: str) -> CVAEConfig:
    """Fail at the boundary when a checkpoint is not an MLP CVAE (JAX
    :149-162): a Conv1D checkpoint's params are conv_i/deconv_i layers."""
    if not isinstance(model_cfg, CVAEConfig):
        raise TypeError(
            f"{purpose} supports the MLP CVAE family only; this checkpoint "
            f"is a {type(model_cfg).__name__} (use the models/conv_cvae.py "
            "APIs for Conv1D checkpoints)"
        )
    return model_cfg


def save_opt_state(directory: str, opt_state) -> str:
    """Persist Adam's state ``{"count", "m", "v"}`` (as ``train(...,
    return_state=True)`` returns it) in JAX's ``opt_state.npz`` layout:
    ``count`` (int32, optax's), ``mu/<layer>/<leaf>`` and ``nu/...``."""
    os.makedirs(directory, exist_ok=True)
    flat = {"count": np.asarray(int(opt_state["count"]), np.int32)}
    for key, tree in (("mu", opt_state["m"]), ("nu", opt_state["v"])):
        for name, layer in params_to_numpy(tree).items():
            for leaf, a in layer.items():
                flat[f"{key}/{name}/{leaf}"] = a
    np.savez(os.path.join(directory, "opt_state.npz"), **flat)
    return directory


def load_opt_state(directory: str, params) -> Optional[Dict[str, Any]]:
    """The state :func:`save_opt_state` (or JAX's) wrote, on ``params``'
    device as ``{"count": int, "m", "v"}``, ready for ``train(init_state=
    (params, state))``; None when the directory holds none.  Raises when its
    layers or shapes are not ``params``'."""
    path = os.path.join(directory, "opt_state.npz")
    if not os.path.exists(path):
        return None
    state: Dict[str, Any] = {"m": {}, "v": {}}
    with np.load(path) as z:
        state["count"] = int(z["count"])
        for key in z.files:
            if key == "count":
                continue
            which, layer, leaf = key.split("/")
            ref = params[layer][leaf]
            a = torch.as_tensor(z[key])
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"{key} has shape {tuple(a.shape)}, the params "
                                 f"{tuple(ref.shape)}")
            state["m" if which == "mu" else "v"].setdefault(layer, {})[leaf] = \
                a.to(device=ref.device, dtype=ref.dtype)
    for which in ("m", "v"):
        missing = [f"{k}/{n}" for k in params for n in params[k]
                   if n not in state[which].get(k, {})]
        if missing:
            raise ValueError(f"{path} lacks {which} for {missing}")
    return state


def load_history(directory: str) -> Optional[Dict[str, np.ndarray]]:
    """The loss curves saved beside the params, or None."""
    path = os.path.join(directory, "history.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}

