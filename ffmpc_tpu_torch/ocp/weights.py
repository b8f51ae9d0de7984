"""Static OCP cost-stack configuration.

PyTorch counterpart of ``ffmpc_tpu/ocp/weights.py`` (its own copy of the
same presets).  Mirrors the tunables of the reference's MPC configs that parameterize the
*shooting problem itself* (reference ClassicalMPCConfig,
crocoddyl_classical.py:12-110, and ForceFeedbackMPCConfig,
crocoddyl_force_feedback.py:12-147).  Controller-loop knobs (latch, safety
filter, solver budget, ...) live in the ``mpc`` package.

Everything here is static/hashable;
per-solve array data (trajectory refs, regularization references) travels
separately as ``ProblemRefs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device


def _t7(x) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.broadcast_to(np.asarray(x, dtype=float), (7,)))


@dataclass(frozen=True)
class OCPWeights:
    """Cost weights + contact parameters for one knot family (static)."""

    dt_ocp: float = 0.01

    # free-space tracking
    w_ee_pos: float = 2.0e2
    ee_pos_weights: Tuple[float, float, float] = (1.0, 1.0, 2.5)
    w_ee_ori: float = 1.0e1
    ori_weights: Tuple[float, float, float] = (2.0, 2.0, 0.15)

    # regularization
    w_posture: float = 5.0e-1
    w_v: float = 2.5e-1
    v_damp_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 0.4, 0.4, 0.4)
    w_tau: float = 1.0e-3
    w_tau_soft_limits: float = 0.0
    tau_soft_limit_margin: float = 0.2
    w_q_soft_limits: float = 0.0
    q_soft_limit_margin: float = 0.05

    # orientation damping
    w_wdamp: float = 2.0e1
    w_wdamp_weights: Tuple[float, float, float] = (1.5, 1.5, 0.2)

    # contact phase objectives
    z_press: float = 0.0020
    w_plane_z: float = 0.0
    w_vz: float = 0.0
    w_tangent_pos: float = 2.0e2
    w_tangent_vel: float = 1.0e2

    # contact modeling
    contact_model: str = "normal_1d"      # or "point3d"
    mu: float = 0.6
    friction_margin: float = 1.0e-3
    w_friction_cone: float = 2.0e2
    w_unilateral: float = 5.0e1
    contact_gains: Tuple[float, float] = (0.0, 60.0)   # Baumgarte (kp, kd)
    contact_inv_damping: float = 1.0e-8

    # normal-force objective
    fn_des: float = 8.0
    w_fn: float = 2.0e1

    # torque box
    tau_limits: Tuple[float, ...] = (87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0)

    # ---- force-feedback augmentation (used by the augmented knot only) ----
    # (reference _AugmentedLPFActionModel, crocoddyl_force_feedback.py:149-290)
    ff_alpha: float = 0.0             # LPF pole exp(-2*pi*fc*dt_ocp)
    w_w: float = 8.0e-4               # w (unfiltered input) regularization
    w_w_soft_limits: float = 2.0
    w_y: float = 3.0e-3               # augmented-state regularization
    y_weights: Tuple[float, ...] = tuple(
        [0.2, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1]
        + [0.08, 0.08, 0.08, 0.08, 0.05, 0.05, 0.05]
        + [0.35, 0.35, 0.35, 0.35, 0.2, 0.2, 0.2]
    )
    use_inner_state_reg: bool = True
    use_inner_tau_reg: bool = True


FLAGSHIP_FF_CUTOFF_HZ = 25.0
FLAGSHIP_DT_OCP = 0.01
FLAGSHIP_DT_MPC = 0.005
FLAGSHIP_Z_CONTACT = 0.342


def flagship_ff_alpha(dt: float = FLAGSHIP_DT_OCP) -> float:
    """LPF pole exp(-2*pi*fc*dt) at the benchmark cutoff (reference
    _ff_alpha_ocp/_ctrl, crocoddyl_force_feedback.py:493-499)."""
    return float(np.exp(-2.0 * np.pi * FLAGSHIP_FF_CUTOFF_HZ * dt))


def flagship_weights() -> "OCPWeights":
    """The single source of truth for the flagship benchmark OCP config
    (N=40 force-feedback augmented contact problem).  Every entry point that
    solves the flagship problem builds it from here."""
    return OCPWeights(
        dt_ocp=FLAGSHIP_DT_OCP, w_ee_pos=1.2e3, w_ee_ori=4.5e1,
        w_q_soft_limits=8.0, w_tau_soft_limits=1.5,
        w_plane_z=9.0e2, w_vz=3.0e2, w_tangent_pos=3.6e3, w_tangent_vel=1.2e3,
        contact_gains=(145.0, 85.0), fn_des=22.0, w_fn=3.0e1,
        w_unilateral=3.0e1, w_friction_cone=0.0, z_press=0.0065,
        ff_alpha=flagship_ff_alpha(), w_w=6.0e-4, w_w_soft_limits=2.0,
        w_y=8.0e-4,
    )


def flagship_trajectory():
    """The flagship approach-then-circle task (circle r=0.10 m at
    omega=1.5 rad/s on the table plane; reference run_classical.py:712-713)."""
    from ..tasks.trajectories import ApproachCircleTraj
    z = FLAGSHIP_Z_CONTACT
    return ApproachCircleTraj(
        center=(-0.5, 0.0, z), radius=0.10, omega=1.5,
        z_contact=z, t_approach=0.55, z_pre=z + 0.05,
        t_pre=0.25, ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.2)


class ProblemRefs(NamedTuple):
    """Per-solve tensor data for a batch of shooting problems.  Running
    refs carry leading dims (B, N); terminal refs (B,); a single knot's
    slice carries whatever leading dims the knot function is called with."""

    p_ref: torch.Tensor      # (..., 3)  ee position reference (world)
    v_ref: torch.Tensor      # (..., 3)  ee linear-velocity reference
    x_reg_ref: torch.Tensor  # (..., 14) posture regularization reference
    tau_ref: torch.Tensor    # (..., 7)  torque regularization reference (gravity)
    R_des: torch.Tensor      # (..., 3, 3) desired ee orientation (world)
    y_ref: torch.Tensor      # (..., 21) augmented-state reg reference (FF; zeros otherwise)


def make_problem_refs(p_ref, v_ref, x_reg_ref, tau_ref, R_des, y_ref=None,
                      dtype=torch.float32, device="cuda") -> ProblemRefs:
    dev = resolve_device(device)

    def cast(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x_reg_ref = cast(x_reg_ref)
    if y_ref is None:
        y_ref = torch.zeros(x_reg_ref.shape[:-1] + (21,), dtype=dtype, device=dev)
    return ProblemRefs(
        p_ref=cast(p_ref),
        v_ref=cast(v_ref),
        x_reg_ref=x_reg_ref,
        tau_ref=cast(tau_ref),
        R_des=cast(R_des),
        y_ref=cast(y_ref),
    )


def problem_refs_from_numpy(fields: dict, dtype=torch.float32,
                            device="cuda") -> ProblemRefs:
    """Build ``ProblemRefs`` from a mapping field name -> numpy array (e.g.
    the JAX package's ``ProblemRefs._asdict()`` mapped through
    ``np.asarray``), so two implementations compute on identical data."""
    dev = resolve_device(device)
    missing = set(ProblemRefs._fields) - set(fields)
    if missing:
        raise ValueError(f"missing ProblemRefs fields: {sorted(missing)}")
    return ProblemRefs(**{
        name: torch.tensor(np.array(fields[name]), dtype=dtype, device=dev)
        for name in ProblemRefs._fields})
