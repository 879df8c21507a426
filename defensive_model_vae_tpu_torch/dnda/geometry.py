"""DNDA data structures (reference ``DNDA.py:48-96`` / ``dnda_functions.py:63-86``).

Port of ``defensive_model_vae_tpu/dnda/geometry.py``, unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Road:
    cross_centerline: bool = False
    lane_num: int = 1
    lane_egodirect: int = 1
    lane_width: float = 4.0
    max_absolute_acc: float = 9.8


@dataclasses.dataclass
class Vehicle:
    """Ego vehicle state (angles relative to the y axis, reference
    convention — see ``DNDA_calculator.rotate_vehicle_positions:256-258``)."""

    x: float = 0.0
    y: float = 0.0
    length: float = 5.0
    width: float = 2.0
    speed: float = 0.0
    speed_x: float = 0.0
    speed_y: float = 0.0
    acc: float = 0.0
    init_q: float = 0.0
    lane_posi: float = 1.0
    absolute_theta: float = 0.0
    relative_theta: float = 0.0


@dataclasses.dataclass
class SurroundingVehicle:
    x: float = 0.0
    y: float = 0.0
    length: float = 0.0
    width: float = 0.0
    speed_x: float = 0.0
    speed_y: float = 0.0
    acc_x: float = 0.0
    acc_y: float = 0.0
    heading: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [
                self.x,
                self.y,
                self.length,
                self.width,
                self.speed_x,
                self.speed_y,
                self.acc_x,
                self.acc_y,
                self.heading,
            ]
        )
