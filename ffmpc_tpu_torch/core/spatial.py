"""Minimal batched 3-D spatial-algebra helpers (rotations, quaternions, log maps).

PyTorch counterpart of ``ffmpc_tpu/core/spatial.py``.  Inputs may carry
arbitrary leading batch dimensions; all ops broadcast over them.  Every
function is free of in-place writes and data-dependent Python branches, so
it can be pushed through ``torch.func.jvp`` / ``vmap``.
"""

from __future__ import annotations

import torch


def quat_wxyz_to_rot(q):
    """Rotation matrix from a (w, x, y, z) quaternion. q: (..., 4) -> (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat_wxyz(R):
    """(w,x,y,z) quaternion from rotation matrix; branch-free (Shepperd via stacking).

    R: (..., 3, 3) -> (..., 4).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate branches; pick the numerically safest one per element.
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)

    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)

    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)

    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


def hat(v):
    """Skew-symmetric matrix of v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    r = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return r.reshape(v.shape[:-1] + (3, 3))


def rot_z(theta):
    """Rotation about +z by theta: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    r = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1)
    return r.reshape(theta.shape + (3, 3))


def log3(R):
    """SO(3) log map: rotation matrix -> rotation vector (..., 3).

    Numerically safe near the identity via a Taylor-expanded sinc factor;
    the branch is a ``where`` so forward-mode tangents pass through it.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)
    # vee(R - R^T) / 2 = sin(theta) * axis
    w = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < 1e-5
    # theta/sin(theta), Taylor near 0: 1 + theta^2/6
    sin_t = torch.sin(theta)
    factor = torch.where(small, 1.0 + theta * theta / 6.0,
                         theta / torch.where(small, torch.ones_like(sin_t), sin_t))
    return w * factor[..., None]
