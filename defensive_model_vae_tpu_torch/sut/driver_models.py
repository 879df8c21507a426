"""Rule-based driver models (reference ``Driver_Models.py``).

Port of ``defensive_model_vae_tpu/sut/driver_models.py``, unchanged.
"""

from __future__ import annotations

from typing import Optional


def reg157_brake(
    x_ego: float, v_ego: float, x_front: float, v_front: float,
    max_decel: float = 6.0, reaction_margin: float = 0.35,
) -> Optional[float]:
    """UN Regulation 157-style emergency-brake rule.

    Returns the brake deceleration (−max_decel) when the ego is closing on
    the lead vehicle (v_rel > 0) and the time-to-collision has fallen to or
    below ``v_rel / (2·max_decel) + margin``; otherwise None (no
    intervention).

    Preserved-quirk note: the reference (``Driver_Models.py:5-8``) brakes
    when ``ttc > threshold`` — i.e. it intervenes in every *safe* state and
    does nothing once a collision is imminent, and it divides by ``v_rel``
    without guarding zero.  That inversion is a latent defect (the stub is
    unused elsewhere in the reference), so per project policy (CLAUDE.md:
    latent reference defects are fixed, not reproduced) this implementation
    uses the physically meaningful ``ttc <= threshold`` trigger and guards
    the non-closing case.
    """
    v_rel = v_ego - v_front
    if v_rel <= 0:  # not closing → no collision course, never brake
        return None
    ttc = abs(x_front - x_ego) / v_rel
    threshold = v_rel / (2 * max_decel) + reaction_margin
    if ttc <= threshold:
        return -max_decel
    return None
