"""The scenario constants this slice of the port reads.

A copy of what the pipeline needs from ``defensive_model_vae_tpu/scenarios.py``
(``REGISTRY``, :355-501): each scenario's key, town and tracking time step,
plus the committed fixture windows.  The CSV predicates, plotting, DNDA and
SUT constants of the JAX registry come with the ``data/`` and ``metrics/``
slices.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Dict

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "fixtures"


@dataclasses.dataclass(frozen=True)
class Scenario:
    key: str  # 'sce1'..'sce4'
    town: str  # CARLA town folder name
    dt: float  # simulation / tracking time step in seconds

    @property
    def fixture_windows(self) -> pathlib.Path:
        """The committed (N, 10, 3) [t, x, y] training windows."""
        return FIXTURES / f"trajectory_{self.key}_cond.npy"


REGISTRY: Dict[str, Scenario] = {
    "sce1": Scenario("sce1", "StaticBlindTown05", 0.02),
    "sce2": Scenario("sce2", "DynamicBlindTown05", 0.025),
    "sce3": Scenario("sce3", "PredictableMovementTown05", 0.015),
    "sce4": Scenario("sce4", "UnpredictableMovementTown04", 0.02),
}

TOWN_TO_KEY = {s.town: s.key for s in REGISTRY.values()}
_SCE_RE = re.compile(r"sce([1-4])")


def get(key_or_name: str) -> Scenario:
    """Resolve a scenario from a key ('sce3'), a town name, or any string
    containing a scenario key (as ``scenarios.get`` of the JAX package)."""
    if key_or_name in REGISTRY:
        return REGISTRY[key_or_name]
    if key_or_name in TOWN_TO_KEY:
        return REGISTRY[TOWN_TO_KEY[key_or_name]]
    m = _SCE_RE.search(key_or_name)
    if m:
        return REGISTRY["sce" + m.group(1)]
    raise KeyError(f"unknown scenario: {key_or_name!r}")
