"""Batched forward kinematics, frame Jacobians and frame velocities.

PyTorch counterpart of ``ffmpc_tpu/core/kinematics.py``: the 7-joint serial
chain is unrolled into 3x3 matrix ops that broadcast over arbitrary leading
batch dimensions.  Jacobians are world-aligned (linear/angular axes expressed
in world frame, taken at the frame origin).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .panda import PandaModel
from .spatial import rot_z


class FKResult(NamedTuple):
    R: torch.Tensor        # (..., 7, 3, 3) world rotations of link frames 1..7
    p: torch.Tensor        # (..., 7, 3)    world positions of link-frame origins
    axis_w: torch.Tensor   # (..., 7, 3)    world joint axes (+z of each link frame)
    ee_R: torch.Tensor     # (..., 3, 3)    world rotation of the tool/ee frame
    ee_p: torch.Tensor     # (..., 3)       world position of the tool/ee frame


def fk(model: PandaModel, q: torch.Tensor) -> FKResult:
    """Forward kinematics. q: (..., 7)."""
    batch = q.shape[:-1]
    R_w = model.base_rot.expand(batch + (3, 3))
    p_w = model.base_pos.expand(batch + (3,))

    Rs, ps, axes = [], [], []
    for i in range(7):
        Rj = model.j_rot[i] @ rot_z(q[..., i])          # (...,3,3)
        p_w = p_w + R_w @ model.j_pos[i]
        R_w = R_w @ Rj
        Rs.append(R_w)
        ps.append(p_w)
        axes.append(R_w[..., :, 2])

    ee_R = R_w @ model.ee_rot
    ee_p = p_w + R_w @ model.ee_pos
    return FKResult(
        R=torch.stack(Rs, dim=-3),
        p=torch.stack(ps, dim=-2),
        axis_w=torch.stack(axes, dim=-2),
        ee_R=ee_R,
        ee_p=ee_p,
    )


def ee_jacobian(model: PandaModel, q: torch.Tensor,
                fk_res: Optional[FKResult] = None):
    """World-aligned frame Jacobian at the ee frame origin.

    Returns (J_pos, J_rot), each (..., 3, 7): column j is the world-frame
    linear / angular velocity of the ee frame per unit qdot_j.
    """
    f = fk_res if fk_res is not None else fk(model, q)
    r = f.ee_p[..., None, :] - f.p            # (..., 7, 3) joint->ee offsets
    jp = torch.linalg.cross(f.axis_w, r)      # (..., 7, 3)
    J_pos = jp.transpose(-1, -2)              # (..., 3, 7)
    J_rot = f.axis_w.transpose(-1, -2)        # (..., 3, 7)
    return J_pos, J_rot


def ee_velocity(model: PandaModel, q: torch.Tensor, v: torch.Tensor,
                fk_res: Optional[FKResult] = None):
    """World-aligned ee frame velocity (linear, angular), each (..., 3)."""
    J_pos, J_rot = ee_jacobian(model, q, fk_res)
    lin = (J_pos @ v[..., None])[..., 0]
    ang = (J_rot @ v[..., None])[..., 0]
    return lin, ang
