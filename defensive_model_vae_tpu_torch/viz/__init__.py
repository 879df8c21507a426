"""Figures and animations on the host (matplotlib, Pillow): the port's
only matplotlib user.  The card path never imports this package."""

from .losses import plot_losses, save_loss_csv, load_loss_csv
from .plots import (
    plot_velocity_distribution,
    plot_spatial_distribution,
    plot_tracking_results,
    plot_speed_time_curves,
    plot_static_case,
    plot_histogram,
    plot_spatiotemporal,
    plot_space_time_velocity,
    unified_colorbar_range,
)
from .gif import (
    vehicle_rectangle,
    smooth_curve,
    animate_human_vs_model,
    animate_tracking,
)

__all__ = [
    "plot_losses",
    "save_loss_csv",
    "load_loss_csv",
    "plot_velocity_distribution",
    "plot_spatial_distribution",
    "plot_tracking_results",
    "plot_speed_time_curves",
    "plot_static_case",
    "plot_histogram",
    "plot_spatiotemporal",
    "plot_space_time_velocity",
    "unified_colorbar_range",
    "vehicle_rectangle",
    "smooth_curve",
    "animate_human_vs_model",
    "animate_tracking",
]
