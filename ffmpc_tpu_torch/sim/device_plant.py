"""Batched Panda + table plant on the device.

PyTorch counterpart of ``ffmpc_tpu/sim/device_plant.py``: a functional twin
of the host MuJoCo plant for closed-loop rollouts, every plant of a batch
stepped at once (leading batch dims), with no host round trip.

Semantics mirrored from the reference plant and its scene:

- torque injection equivalent to ``qfrc_applied`` with actuators disabled;
- implicitfast-style integration: joint damping handled implicitly
  (v+ = (M + h D)^-1 (M v + h (tau - b_nodamp))), MuJoCo's ``implicitfast``
  at the 1 kHz physics rate;
- the single ee-sphere <-> table-plane condim=1 (frictionless) contact via
  MuJoCo's soft-constraint model: solref=(0.02, 1), solimp=(0.9, 0.95,
  0.001, 0.5, 2), margin 2 mm, solved exactly for one contact
  (f = clip(d (aref - a0) / A, 0, inf) with R = A (1-d)/d);
- the observation channels of the reference, including the tau_meas /
  tau_meas_act EMA low-pass states and the |fn| channel;
- table tilt as a plant parameter.

The host MuJoCo plant remains the arbiter; the JAX package's tests compare
the two, and ``tests/test_torch_plant.py`` holds this module to the JAX one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.panda import PandaModel, TOOL_SPHERE_RADIUS
from ..core.kinematics import fk, ee_jacobian
from ..core.dynamics import rnea, mass_matrix
from ..core.smallchol import chol_factor, chol_solve, spd_solve, matvec


class TableParams(NamedTuple):
    """Contact-table geometry + MuJoCo soft-constraint constants (0-d or
    (3,) tensors)."""
    point: torch.Tensor      # (3,) a point on the contact plane (world)
    normal: torch.Tensor     # (3,) unit plane normal (world)
    margin: torch.Tensor
    timeconst: torch.Tensor  # solref[0]
    dampratio: torch.Tensor  # solref[1]
    dmin: torch.Tensor
    dmax: torch.Tensor
    width: torch.Tensor
    midpoint: torch.Tensor
    power: torch.Tensor
    diag_approx: torch.Tensor  # MuJoCo efc_diagA for this contact pair


def make_table_params(tilt_deg: float = 0.0, dtype=torch.float32, device="cuda",
                      table_body_pos=(-0.5, 0.0, 0.3),
                      plane_offset: float = 0.02) -> TableParams:
    """Table plane after an optional hidden tilt about world y through the
    table body origin (the scenario tilt of the reference)."""
    dev = resolve_device(device)
    a = np.deg2rad(float(tilt_deg))
    R = np.array([[np.cos(a), 0.0, np.sin(a)],
                  [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    body = np.asarray(table_body_pos)
    point = body + R @ np.array([0.0, 0.0, plane_offset])
    normal = R @ np.array([0.0, 0.0, 1.0])

    def c(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=dev)
    # includemargin: MuJoCo sums the two geoms' margins (ee_collision 1 mm +
    # table_contact 1 mm -> 2 mm force-onset distance).  MuJoCo regularizes
    # with R = (1-d)/d * efc_diagA, where efc_diagA is not the exact
    # A = J M^-1 J^T but the compile-time sum of the two bodies'
    # translational body_invweight0 (table static -> 0; ee tool body ->
    # 0.1235373 for this scene).
    return TableParams(
        point=c(point), normal=c(normal), margin=c(2.0e-3),
        timeconst=c(0.02), dampratio=c(1.0),
        dmin=c(0.9), dmax=c(0.95), width=c(1.0e-3), midpoint=c(0.5),
        power=c(2.0), diag_approx=c(0.1235373),
    )


class PlantState(NamedTuple):
    q: torch.Tensor                  # (..., 7)
    v: torch.Tensor                  # (..., 7)
    tau_meas_filt: torch.Tensor      # (..., 7) EMA state
    tau_meas_act_filt: torch.Tensor  # (..., 7) EMA state


class DeviceObs(NamedTuple):
    """The observation channels that exist in the frictionless device plant
    (tau_act == 0 with disabled actuators)."""
    q: torch.Tensor
    dq: torch.Tensor
    tau_meas: torch.Tensor
    tau_meas_filt: torch.Tensor
    tau_meas_act: torch.Tensor
    tau_meas_act_filt: torch.Tensor
    tau_cmd: torch.Tensor
    tau_constraint: torch.Tensor
    tau_total: torch.Tensor
    tau_bias: torch.Tensor
    f_contact_normal: torch.Tensor
    f_contact_normal_world_z: torch.Tensor
    contact: torch.Tensor            # bool: active contact
    table_normal_world: torch.Tensor
    ee_pos: torch.Tensor
    ee_vel: torch.Tensor


def _impedance(table: TableParams, r):
    """MuJoCo solimp impedance d(r) for penetration r >= 0."""
    x = torch.clamp(r / torch.clamp(table.width, min=1e-12), 0.0, 1.0)
    p = table.power
    mid = table.midpoint
    # MuJoCo's sigmoid, split at the midpoint
    lo = 0.5 * torch.pow(x / mid, p)
    hi = 1.0 - 0.5 * torch.pow((1.0 - x) / (1.0 - mid), p)
    y = torch.where(x < mid, lo, hi)
    return table.dmin + (table.dmax - table.dmin) * y


def _contact_force(table: TableParams, minv_tau, M_L, Jn, vel_n, dist):
    """Normal force of the single frictionless contact, MuJoCo soft model.

    dist: signed gap (sphere surface to plane, negative = penetrating).
    Returns (fn >= 0, active mask).
    """
    active = dist < table.margin
    # MuJoCo constraint pos for contacts: dist - margin (negative when active)
    pos = dist - table.margin
    r_pen = torch.clamp(-pos, min=0.0)
    d = _impedance(table, r_pen)

    k = 1.0 / (table.dmax * table.dmax * table.timeconst * table.timeconst
               * table.dampratio * table.dampratio)
    b = 2.0 / (table.dmax * table.timeconst)
    aref = -b * vel_n - k * d * pos

    # A = J M^-1 J^T (scalar, exact), a0 = J M^-1 (tau - bias).  The drift
    # Jdot*v is deliberately absent: MuJoCo's constraint residual is
    # jar = J qacc - aref (efc_b = J qacc_smooth - aref), i.e. the arbiter
    # itself omits it; adding it here would diverge from MuJoCo.
    # Regularization uses MuJoCo's compile-time diagonal approximation (see
    # make_table_params), not the exact A.
    Minv_Jt = chol_solve(M_L, Jn)
    A = torch.sum(Jn * Minv_Jt, dim=-1)
    a0 = torch.sum(Jn * minv_tau, dim=-1)
    R = torch.clamp(table.diag_approx * (1.0 - d) / torch.clamp(d, min=1e-6), min=1e-12)
    f = (aref - a0) / (A + R)
    f = torch.where(active, torch.clamp(f, min=0.0), torch.zeros_like(f))
    return f, active


def plant_step(model: PandaModel, table: TableParams, state: PlantState, tau_cmd, *,
               timestep: float = 0.001, n_substeps: int = 5, lpf_alpha: float = 0.2):
    """Advance the plant by one control period (``n_substeps`` physics steps).

    Returns (new_state, DeviceObs at the final substep).  Broadcasts over
    leading batch dims."""
    h = timestep
    D = model.damping
    n = table.normal
    q, v = state.q, state.v
    for _ in range(n_substeps):
        fk_res = fk(model, q)
        Jp, _ = ee_jacobian(model, q, fk_res=fk_res)
        Jn = torch.einsum("i,...ij->...j", n, Jp)               # (..., 7)
        p_rel = fk_res.ee_p - table.point
        dist = torch.einsum("...i,i->...", p_rel, n) - TOOL_SPHERE_RADIUS
        vel_n = torch.sum(Jn * v, dim=-1)

        M = mass_matrix(model, q)
        M_L = chol_factor(M)
        bias_nodamp = rnea(model, q, v, torch.zeros_like(q)) - D * v
        tau_eff = tau_cmd - bias_nodamp
        minv_tau = chol_solve(M_L, tau_eff)

        fn, active = _contact_force(table, minv_tau, M_L, Jn, vel_n, dist)
        tau_con = Jn * fn[..., None]

        # implicit damping: (M + h D) v+ = M v + h (tau_eff + tau_con)
        Mi = M + h * torch.diag(D)
        rhs = matvec(M, v) + h * (tau_eff + tau_con)
        v = spd_solve(Mi, rhs)
        q = q + h * v

    # observation at the final substep (tau channels as the host plant defines)
    fk_res = fk(model, q)
    Jp, _ = ee_jacobian(model, q, fk_res=fk_res)
    tau_bias = rnea(model, q, v, torch.zeros_like(q)) - D * v
    tau_total = tau_cmd + tau_con
    tau_meas_act = tau_cmd
    a = lpf_alpha
    tmf = (1 - a) * state.tau_meas_filt + a * tau_total
    tmaf = (1 - a) * state.tau_meas_act_filt + a * tau_meas_act

    fn_world_z = fn * n[2]
    obs = DeviceObs(
        q=q, dq=v,
        tau_meas=tau_total, tau_meas_filt=tmf,
        tau_meas_act=tau_meas_act, tau_meas_act_filt=tmaf,
        tau_cmd=tau_cmd, tau_constraint=tau_con, tau_total=tau_total,
        tau_bias=tau_bias,
        f_contact_normal=torch.abs(fn),
        f_contact_normal_world_z=torch.clamp(fn_world_z, min=0.0),
        contact=active,
        table_normal_world=n.expand(q.shape[:-1] + (3,)),
        ee_pos=fk_res.ee_p,
        ee_vel=matvec(Jp, v),
    )
    return PlantState(q=q, v=v, tau_meas_filt=tmf, tau_meas_act_filt=tmaf), obs


def init_plant_state(q0, dtype=torch.float32, device="cuda") -> PlantState:
    """Plant at rest at ``q0`` (..., 7), filters at zero."""
    q0 = torch.as_tensor(q0, dtype=dtype, device=resolve_device(device))
    z = torch.zeros_like(q0)
    return PlantState(q=q0, v=z, tau_meas_filt=z, tau_meas_act_filt=z)
