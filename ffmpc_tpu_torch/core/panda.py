"""Static 7-DoF Franka Panda model constants, expressed in the MuJoCo world frame.

PyTorch counterpart of ``ffmpc_tpu/core/panda.py``: the same physical
constants (its own copy), held as tensors on an explicit device.

The reference builds its controller model through Pinocchio's URDF panda and
then calibrates a MuJoCo<->Pinocchio frame chain at runtime
(crocoddyl_classical.py:149-258).  We instead build the rigid-body model
directly from the same physical constants in the *MuJoCo* frame (the scene's
``panda_robot.xml`` inertials, which are the public Franka URDF data as
converted by mujoco_menagerie), so every frame transform between controller
model and plant is identity by construction.  The runtime alignment-check
harness (run_classical.py:113-178 in the reference) is kept as a test.

Physical constants source: Franka Emika Panda URDF / mujoco_menagerie
"panda nohand" MJCF (reference assets/scenes/panda_robot.xml:96-236).

Two variants:
- ``plant``  : matches the simulated plant exactly — joint armature 0.1,
               viscous damping 1.0, and the 0.03 m tool sphere's mass folded
               into link7.  Best closed-loop model.
- ``parity`` : no armature / damping / tool mass — mirrors what the
               reference's Pinocchio-based OCP model uses for the arm links
               (the reference's own model-vs-plant mismatch).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device


class PandaModel(NamedTuple):
    """Immutable model constants; a NamedTuple of tensors on one device.

    Frames: joint i's frame is body ``link{i+1}``'s frame; the end-effector
    frame is the ``tool`` body (= ``ee_site``) under link7.
    """

    base_rot: torch.Tensor   # (3,3)  world rotation of link0
    base_pos: torch.Tensor   # (3,)
    j_pos: torch.Tensor      # (7,3)  fixed parent->child translation per joint
    j_rot: torch.Tensor      # (7,3,3) fixed parent->child rotation per joint
    ee_pos: torch.Tensor     # (3,)   link7->tool translation
    ee_rot: torch.Tensor     # (3,3)  link7->tool rotation
    mass: torch.Tensor       # (7,)   link masses (links 1..7)
    com: torch.Tensor        # (7,3)  COM in body frame
    inertia: torch.Tensor    # (7,3,3) rotational inertia about COM, body frame
    armature: torch.Tensor   # (7,)   reflected rotor inertia
    damping: torch.Tensor    # (7,)   viscous joint damping
    q_lower: torch.Tensor    # (7,)
    q_upper: torch.Tensor    # (7,)
    tau_limit: torch.Tensor  # (7,)
    gravity: torch.Tensor    # (3,)   world gravity vector


NQ = 7
NV = 7
NX = 14  # (q, v)

# ---- raw constants (MuJoCo MJCF "panda nohand") ------------------------------

# quaternions (w,x,y,z) for fixed parent->child rotations
_S2 = 1.0 / np.sqrt(2.0)
_TREE = {
    # name: (parent->child pos, parent->child quat wxyz)
    "link1": ([0.0, 0.0, 0.333], [1.0, 0.0, 0.0, 0.0]),
    "link2": ([0.0, 0.0, 0.0], [_S2, -_S2, 0.0, 0.0]),
    "link3": ([0.0, -0.316, 0.0], [_S2, _S2, 0.0, 0.0]),
    "link4": ([0.0825, 0.0, 0.0], [_S2, _S2, 0.0, 0.0]),
    "link5": ([-0.0825, 0.384, 0.0], [_S2, -_S2, 0.0, 0.0]),
    "link6": ([0.0, 0.0, 0.0], [_S2, _S2, 0.0, 0.0]),
    "link7": ([0.088, 0.0, 0.0], [_S2, _S2, 0.0, 0.0]),
}
_BASE_QUAT = [0.0, 0.0, 0.0, 1.0]          # link0: 180 deg about z
_TOOL_POS = [0.0, 0.0, 0.107]
_TOOL_QUAT = [0.3826834, 0.0, 0.0, 0.9238795]  # 135 deg about z

# (mass, com xyz, fullinertia Ixx Iyy Izz Ixy Ixz Iyz) about COM in body frame
_INERTIAL = [
    (4.970684, [0.003875, 0.002081, -0.04762],
     [0.70337, 0.70661, 0.0091170, -0.000139, 0.0067720, 0.019169]),
    (0.646926, [-0.003141, -0.02872, 0.003495],
     [0.0079620, 2.8110e-2, 2.5995e-2, -3.925e-3, 1.0254e-2, 7.04e-4]),
    (3.228604, [2.7518e-2, 3.9252e-2, -6.6502e-2],
     [3.7242e-2, 3.6155e-2, 1.083e-2, -4.761e-3, -1.1396e-2, -1.2805e-2]),
    (3.587895, [-5.317e-2, 1.04419e-1, 2.7454e-2],
     [2.5853e-2, 1.9552e-2, 2.8323e-2, 7.796e-3, -1.332e-3, 8.641e-3]),
    (1.225946, [-1.1953e-2, 4.1065e-2, -3.8437e-2],
     [3.5549e-2, 2.9474e-2, 8.627e-3, -2.117e-3, -4.037e-3, 2.29e-4]),
    (1.666555, [6.0149e-2, -1.4117e-2, -1.0517e-2],
     [1.964e-3, 4.354e-3, 5.433e-3, 1.09e-4, -1.158e-3, 3.41e-4]),
    (7.35522e-01, [1.0517e-2, -4.252e-3, 6.1597e-2],
     [1.2516e-2, 1.0027e-2, 4.815e-3, -4.28e-4, -1.196e-3, -7.41e-4]),
]

Q_LOWER = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973])
Q_UPPER = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973])
TAU_LIMIT = np.array([87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0])
TAU_RATE_LIMIT = np.array([450.0, 450.0, 450.0, 450.0, 180.0, 180.0, 180.0])  # Nm/s

KEYFRAMES = {
    "home": np.array([0.0, 0.0, 0.0, -1.57079, 0.0, 1.57079, -0.7853]),
    "neutral": np.array([0.0, -0.758, 0.0, -2.22, 0.0, 1.43, 0.0]),
}

# tool collision sphere (ee_collision geom): radius 0.03 m, MuJoCo default
# density 1000 kg/m^3 -> MuJoCo-derived body mass/inertia for the tool body.
TOOL_SPHERE_RADIUS = 0.03
_TOOL_MASS = 1000.0 * (4.0 / 3.0) * np.pi * TOOL_SPHERE_RADIUS ** 3
_TOOL_INERTIA = 0.4 * _TOOL_MASS * TOOL_SPHERE_RADIUS ** 2  # solid sphere, diag


def _np_quat_to_rot(q):
    w, x, y, z = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _full_to_mat(full):
    ixx, iyy, izz, ixy, ixz, iyz = full
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _fuse_tool_into_link7(mass7, com7, I7):
    """Fold the fixed tool body's point mass + sphere inertia into link7.

    The tool body sits at ``_TOOL_POS`` in link7's frame (its rotation does not
    matter for a sphere).  Standard composite-body fusion about the combined COM.
    """
    p = np.asarray(_TOOL_POS)
    m_t = _TOOL_MASS
    m = mass7 + m_t
    com = (mass7 * com7 + m_t * p) / m
    # parallel-axis both inertias to the combined COM
    def _shift(I, m_i, c_i):
        d = c_i - com
        return I + m_i * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    I = _shift(I7, mass7, com7) + _shift(np.eye(3) * _TOOL_INERTIA, m_t, p)
    return m, com, I


def make_panda_model(variant: str = "plant", dtype=torch.float32,
                     device="cuda") -> PandaModel:
    """Build the Panda model constants.

    variant "plant": armature 0.1, damping 1.0, tool mass fused into link7
    (exactly the simulated plant).  variant "parity": zero armature/damping,
    bare link7 (the reference controller's internal-model convention).
    """
    if variant not in ("plant", "parity"):
        raise ValueError(f"unknown variant {variant!r}")

    names = [f"link{i}" for i in range(1, 8)]
    j_pos = np.stack([np.asarray(_TREE[n][0], dtype=np.float64) for n in names])
    j_rot = np.stack([_np_quat_to_rot(_TREE[n][1]) for n in names])

    mass = np.array([it[0] for it in _INERTIAL])
    com = np.stack([np.asarray(it[1], dtype=np.float64) for it in _INERTIAL])
    inertia = np.stack([_full_to_mat(it[2]) for it in _INERTIAL])

    if variant == "plant":
        m7, c7, I7 = _fuse_tool_into_link7(mass[6], com[6], inertia[6])
        mass = mass.copy(); com = com.copy(); inertia = inertia.copy()
        mass[6], com[6], inertia[6] = m7, c7, I7
        armature = np.full(7, 0.1)
        damping = np.full(7, 1.0)
    else:
        armature = np.zeros(7)
        damping = np.zeros(7)

    return panda_model_from_numpy(dict(
        base_rot=_np_quat_to_rot(_BASE_QUAT),
        base_pos=np.zeros(3),
        j_pos=j_pos,
        j_rot=j_rot,
        ee_pos=np.asarray(_TOOL_POS),
        ee_rot=_np_quat_to_rot(_TOOL_QUAT),
        mass=mass,
        com=com,
        inertia=inertia,
        armature=armature,
        damping=damping,
        q_lower=Q_LOWER,
        q_upper=Q_UPPER,
        tau_limit=TAU_LIMIT,
        gravity=np.array([0.0, 0.0, -9.81]),
    ), dtype=dtype, device=device)


def panda_model_from_numpy(fields: dict, dtype=torch.float32,
                           device="cuda") -> PandaModel:
    """Build a ``PandaModel`` from a mapping field name -> numpy array.

    Lets a caller that holds the same constants in another array library
    (e.g. the JAX package's ``PandaModel._asdict()`` mapped through
    ``np.asarray``) compute on bit-identical values."""
    dev = resolve_device(device)
    missing = set(PandaModel._fields) - set(fields)
    if missing:
        raise ValueError(f"missing PandaModel fields: {sorted(missing)}")
    return PandaModel(**{
        name: torch.tensor(np.array(fields[name], dtype=np.float64),
                           dtype=dtype, device=dev)
        for name in PandaModel._fields})
