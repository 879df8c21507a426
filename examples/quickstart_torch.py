"""End-to-end quickstart of the PyTorch/CUDA port, runnable without the
reference dataset.

Trains a scenario CVAE on the bundled fixture corpus, samples
trajectories, MPC-tracks one and renders figures: the loop of
``examples/quickstart.py`` through ``defensive_model_vae_tpu_torch`` alone.
On the card the tracker runs as one captured CUDA graph a step.

    python examples/quickstart_torch.py [--outdir /tmp/defvae-torch-demo] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/defvae-torch-demo")
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    from defensive_model_vae_tpu_torch import scenarios
    from defensive_model_vae_tpu_torch.control import MPCConfig, PathReference, track
    from defensive_model_vae_tpu_torch.generate import generate_trajectories
    from defensive_model_vae_tpu_torch.models import CVAEConfig
    from defensive_model_vae_tpu_torch.train import TrainConfig, train
    from defensive_model_vae_tpu_torch.train.checkpoint import save_checkpoint
    from defensive_model_vae_tpu_torch.viz import plot_losses, plot_tracking_results
    from defensive_model_vae_tpu_torch.viz.plots import plot_generated_vs_training

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    windows = np.load(os.path.join(here, "fixtures", "trajectory_sce2_cond.npy"))
    sce = scenarios.get("sce2")
    print(f"corpus: {windows.shape} [t, x, y] windows ({sce.town}) on {args.device}")

    # 1. train
    params, hist = train(windows, train_cfg=TrainConfig(epochs=args.epochs),
                         device=args.device)
    print(f"trained {args.epochs} epochs; loss {hist['total'][0]:.1f} → {hist['total'][-1]:.3f}")
    cfg = CVAEConfig()
    save_checkpoint(os.path.join(args.outdir, "ckpt"), params, cfg, "sce2", hist)
    plot_losses(hist, os.path.join(args.outdir, "loss.png"))

    # 2. sample trajectories at a training start point
    start = windows[0, 0, 1:3]
    gen = generate_trajectories(params, cfg, np.tile(start, (6, 1)), seed=4)
    plot_generated_vs_training(
        gen.reshape(-1, 10, 3), windows, sce,
        os.path.join(args.outdir, "generated_vs_training.png"),
    )
    print(f"sampled {gen.shape[0]} trajectories at start {np.round(start, 1)}")

    # 3. MPC-track the first sample
    wp = np.asarray(gen[0, 0])[:, [1, 2, 0]].astype(float)
    wp[0, 2] = 0.0
    v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
    init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
    mpc = MPCConfig(prediction_horizon=30, control_horizon=20, dt=sce.dt)
    times, states, controls = track(wp, init, mpc, device=args.device)
    err = PathReference(wp, init).position_error(times, states[:, :2])
    print(f"tracked {len(times) - 1} steps; position error max {err.max():.2f} m")
    plot_tracking_results(
        times, states, controls, wp, PathReference(wp, init),
        os.path.join(args.outdir, "tracking.png"), axis_flip=sce.axis_flip,
    )

    print(f"figures in {args.outdir}")


if __name__ == "__main__":
    main()
