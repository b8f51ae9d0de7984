"""Controller-side helpers.  PyTorch counterpart of
``ffmpc_tpu/mpc/controllers.py``; only the orientation helper that problem
construction needs is here so far."""

from __future__ import annotations

import numpy as np


def make_vertical_down_R() -> np.ndarray:
    """Desired ee orientation: tool z pointing down, x along world +x."""
    z = np.array([0.0, 0.0, -1.0])
    x = np.array([1.0, 0.0, 0.0])
    y = np.cross(z, x)
    y /= np.linalg.norm(y) + 1e-12
    x = np.cross(y, z)
    x /= np.linalg.norm(x) + 1e-12
    return np.column_stack([x, y, z])
