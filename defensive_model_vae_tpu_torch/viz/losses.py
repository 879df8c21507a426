"""Loss-curve plotting (reference ``Tools.plot_losses``, ``Tools.py:662-771``
and ``Loss_Re-plot.py``): dual-panel figure (total + weighted components)
written next to a machine-readable CSV, reloadable for re-plotting.

Port of ``defensive_model_vae_tpu/viz/losses.py``; the CSV is the same
file, so either package reads the other's (``results/loss/sce*.csv``)."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..models.losses import LossWeights

_COMPONENTS = ("recon", "kld", "start", "time")


def save_loss_csv(history: Dict[str, np.ndarray], csv_path: str):
    keys = ["total"] + list(_COMPONENTS)
    arr = np.column_stack([np.asarray(history[k]) for k in keys])
    header = ",".join(keys)
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    np.savetxt(csv_path, arr, delimiter=",", header=header, comments="")


def load_loss_csv(csv_path: str) -> Dict[str, np.ndarray]:
    arr = np.genfromtxt(csv_path, delimiter=",", names=True)
    return {k: np.asarray(arr[k]) for k in arr.dtype.names}


def plot_losses(
    history: Dict[str, np.ndarray],
    save_path: str,
    weights: LossWeights = LossWeights(),
    title: Optional[str] = None,
):
    """Write the dual-panel loss figure and the sibling CSV.

    Components are scaled by their loss weights for display, like the
    reference (``Training_VAE.py:385-388``); the CSV keeps raw values.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = np.arange(len(history["total"]))
    fig, axes = plt.subplots(1, 2, figsize=(16, 6))

    axes[0].plot(epochs, history["total"], linewidth=2, label="Total Loss")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("Loss")
    axes[0].set_title(title or "Total Loss")
    axes[0].legend()
    axes[0].grid(True, linestyle="--", alpha=0.5)

    w = {
        "recon": weights.recon,
        "kld": weights.kld,
        "start": weights.start,
        "time": weights.time,
    }
    labels = {
        "recon": "Reconstruction Loss",
        "kld": "KLD Loss",
        "start": "Start Loss",
        "time": "Time Loss",
    }
    for k in _COMPONENTS:
        axes[1].plot(epochs, w[k] * np.asarray(history[k]), label=labels[k])
    axes[1].set_xlabel("Epoch")
    axes[1].set_ylabel("Loss")
    axes[1].set_title("Component Losses")
    axes[1].legend()
    axes[1].grid(True, linestyle="--", alpha=0.5)

    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    save_loss_csv(history, os.path.splitext(save_path)[0] + ".csv")
    return save_path
