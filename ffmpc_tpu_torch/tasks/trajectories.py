"""Staged approach-then-circle end-effector trajectory, sampled at tensor times.

PyTorch counterpart of ``ffmpc_tpu/tasks/trajectories.py``: one branchless
function of t, evaluated for a whole tensor of times at once.

traj(t (...,)) -> (p_ref (..., 3), v_ref (..., 3), surface_mode (...,) bool)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def _smoothstep(s):
    s = torch.clamp(s, 0.0, 1.0)
    return s * s * (3.0 - 2.0 * s)


def _dsmoothstep_ds(s):
    s = torch.clamp(s, 0.0, 1.0)
    return 6.0 * s * (1.0 - s)


@dataclass(frozen=True)
class ApproachCircleTraj:
    """Pre-approach -> descend -> circle at z_contact, with optional
    contact-stabilize hold at the circle start.

    All parameters are static floats; an instance is hashable.
    """

    center: Tuple[float, float, float]
    radius: float
    omega: float
    z_contact: float
    t_approach: float = 2.0
    ee_start: Optional[Tuple[float, float, float]] = None
    z_pre: Optional[float] = None
    t_pre: float = 0.0
    t_stabilize: float = 0.0   # hold at circle start after contact begins

    def _points(self):
        center = np.asarray(self.center, dtype=float)
        p_contact_start = center.copy()
        p_contact_start[0] += self.radius
        p_contact_start[2] = self.z_contact
        if self.ee_start is None:
            p_start = p_contact_start.copy()
            p_start[2] += 0.08
        else:
            p_start = np.asarray(self.ee_start, dtype=float)
        z_pre = self.z_pre
        if z_pre is None:
            z_pre = max(self.z_contact + 0.05, float(p_start[2]))
        p_pre = p_contact_start.copy()
        p_pre[2] = z_pre
        return center, p_start, p_pre, p_contact_start

    def __call__(self, t: torch.Tensor):
        """t: floating tensor of any shape (...,); outputs follow its dtype
        and device."""
        dtype, device = t.dtype, t.device
        center, p_start, p_pre, p_cs = (
            torch.as_tensor(a, dtype=dtype, device=device)
            for a in self._points())
        tc = t[..., None]                                   # (..., 1)

        t_pre = max(float(self.t_pre), 0.0)
        t_app = max(float(self.t_approach), 1.0e-6)
        t_contact = t_pre + t_app

        def blend(p0, p1, tau, T):
            s_lin = tau / T
            s = _smoothstep(s_lin)
            dsdt = _dsmoothstep_ds(s_lin) / T
            return (1.0 - s) * p0 + s * p1, dsdt * (p1 - p0)

        # phase 1: pre-approach (only if t_pre > 0)
        if t_pre > 0.0:
            p1, v1 = blend(p_start, p_pre, tc, t_pre)
            p0_app = p_pre
        else:
            p1, v1 = p_start, torch.zeros(3, dtype=dtype, device=device)
            p0_app = p_start

        # phase 2: approach/descend
        p2, v2 = blend(p0_app, p_cs, tc - t_pre, t_app)

        # phase 3: circle (with stabilize-hold at the circle start)
        tt = torch.clamp(t - t_contact, min=0.0)
        th = self.omega * tt
        p3 = torch.stack([
            center[0] + self.radius * torch.cos(th),
            center[1] + self.radius * torch.sin(th),
            torch.full_like(th, self.z_contact),
        ], dim=-1)
        v3 = torch.stack([
            -self.radius * self.omega * torch.sin(th),
            self.radius * self.omega * torch.cos(th),
            torch.zeros_like(th),
        ], dim=-1)
        if self.t_stabilize > 0.0:
            hold = tc < (t_contact + self.t_stabilize)
            p3 = torch.where(hold, p_cs, p3)
            v3 = torch.where(hold, torch.zeros(3, dtype=dtype, device=device), v3)

        in_pre = tc < t_pre
        in_app = (~in_pre) & (tc < t_contact)
        p = torch.where(in_pre, p1, torch.where(in_app, p2, p3))
        v = torch.where(in_pre, v1, torch.where(in_app, v2, v3))
        surface = t >= t_contact
        return p, v, surface
