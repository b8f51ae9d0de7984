"""Benchmark scenario definitions: hidden table tilt, per-joint actuation
scaling, deterministic seeds.

The package's own copy of the MuJoCo-free part of
``ffmpc_tpu/run/scenarios.py``: five scenarios share one protocol; tilts are
applied to the plant after the controller calibrates on the nominal flat
geometry (hidden model mismatch).  The helpers that need a MuJoCo sim
(``table_geometry_world``, ``apply_table_tilt``) come with the host loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SCENARIOS = ("flat", "tilted_5", "tilted_10", "tilted_15", "actuation_uncertainty")

_SEEDS = {"flat": 11, "tilted_5": 12, "tilted_10": 13, "tilted_15": 14,
          "actuation_uncertainty": 15, "tilted": 16}


def scenario_seed(name: str) -> int:
    return int(_SEEDS.get(name, 99))


@dataclass(frozen=True)
class ScenarioSettings:
    tilt_deg: float
    torque_scale: np.ndarray
    label: str


def scenario_settings(name: str) -> ScenarioSettings:
    ones = np.ones(7)
    table = {
        "flat": ScenarioSettings(0.0, ones, "Flat table"),
        "tilted_5": ScenarioSettings(5.0, ones, "Tilted table (5deg)"),
        "tilted_10": ScenarioSettings(10.0, ones, "Tilted table (10deg)"),
        "tilted_15": ScenarioSettings(15.0, ones, "Tilted table (15deg)"),
        "actuation_uncertainty": ScenarioSettings(
            0.0,
            np.array([0.90, 1.08, 0.92, 1.05, 0.88, 1.10, 0.86]),
            "Actuation gain mismatch"),
        "tilted": ScenarioSettings(8.0, ones, "Tilted table (8deg)"),  # legacy alias
    }
    if name not in table:
        raise ValueError(f"Unknown scenario '{name}'")
    return table[name]
