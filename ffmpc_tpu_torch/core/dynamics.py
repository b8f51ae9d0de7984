"""Batched rigid-body dynamics for the Panda chain: RNEA, mass matrix, bias,
free and contact forward dynamics, and their analytic first derivatives.

PyTorch counterpart of ``ffmpc_tpu/core/dynamics.py``.  Recursions over the
7-joint serial chain are unrolled; all ops broadcast over leading batch dims.
Contact dynamics solve the damped KKT system

    [ M   J^T ] [ a ]   [ tau - b          ]
    [ J   -cI ] [-f ] = [ -a0 - baumgarte  ]

via Schur complement with damping c.

Where the JAX package differentiates with ``jax.jacfwd`` / ``jax.jvp``, this
module pushes one-hot tangents with ``torch.func.jvp`` under
``torch.func.vmap`` over the tangent index only (``jac_last``): the functions
are batch-polymorphic, so the problem batch stays an ordinary leading
dimension and the primal chain is evaluated once.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .panda import PandaModel
from .kinematics import FKResult, fk, ee_jacobian
from .smallchol import chol_factor, chol_solve, spd_solve, matvec as _mv
from .spatial import rot_z


def jac_last(f, x):
    """Jacobian of a batch-polymorphic ``f`` with respect to the LAST axis of
    ``x`` (..., n), one forward-mode tangent per coordinate.

    ``f`` may return a tensor or a pytree of tensors; a leaf shaped (..., m)
    comes back as (..., m, n) (differentiation axis last, like
    ``jax.jacfwd`` on an unbatched function).  ``f`` must be free of in-place
    writes and of Python branches on tensor values.
    """
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)

    def push(t):
        return torch.func.jvp(f, (x,), (t.expand(x.shape),))[1]

    tangents = torch.func.vmap(push)(eye)
    return tree_map(lambda a: torch.movedim(a, 0, -1), tangents)


def rnea(model: PandaModel, q, v, a, *, gravity: bool = True,
         joint_terms: bool = True):
    """Recursive Newton-Euler: joint torques realizing acceleration ``a``.

    q, v, a: (..., 7).  Returns tau (..., 7).
    ``joint_terms`` adds armature*qdd + damping*qd (the simulated plant's
    passive/rotor contributions; zero in the "parity" model variant).
    """
    dtype = q.dtype
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=q.device)
    batch = q.shape[:-1]
    cross = torch.linalg.cross

    # base quantities expressed in link frames as we descend
    R_stack = []     # parent->child rotations (for the backward pass)
    w = torch.zeros(batch + (3,), dtype=dtype, device=q.device)
    wd = torch.zeros(batch + (3,), dtype=dtype, device=q.device)
    acc0 = -model.gravity if gravity else torch.zeros_like(model.gravity)
    # base linear acceleration in base frame (gravity trick)
    ac = (model.base_rot.T @ acc0).expand(batch + (3,))

    ws, wds, acs = [], [], []
    for i in range(7):
        R_pi = model.j_rot[i] @ rot_z(q[..., i])              # (...,3,3)
        R_stack.append(R_pi)
        Rt = R_pi.transpose(-1, -2)
        p = model.j_pos[i].expand(batch + (3,))
        qd = v[..., i:i + 1]
        qdd = a[..., i:i + 1]

        w_p = _mv(Rt, w)
        wd_new = _mv(Rt, wd) + cross(w_p, qd * ez) + qdd * ez
        ac = _mv(Rt, ac + cross(wd, p) + cross(w, cross(w, p)))
        w = w_p + qd * ez
        wd = wd_new
        ws.append(w); wds.append(wd); acs.append(ac)

    # backward pass
    f = torch.zeros(batch + (3,), dtype=dtype, device=q.device)
    n = torch.zeros(batch + (3,), dtype=dtype, device=q.device)
    tau = [None] * 7
    for i in range(6, -1, -1):
        c = model.com[i].expand(batch + (3,))
        m = model.mass[i]
        I = model.inertia[i]
        w_i, wd_i, a_i = ws[i], wds[i], acs[i]
        a_c = a_i + cross(wd_i, c) + cross(w_i, cross(w_i, c))
        F = m * a_c
        Iw = w_i @ I.T
        N = wd_i @ I.T + cross(w_i, Iw)

        f_i = F + f
        n_i = N + cross(c, F) + n
        tau_i = n_i[..., 2]
        if joint_terms:
            tau_i = tau_i + model.armature[i] * a[..., i] + model.damping[i] * v[..., i]
        tau[i] = tau_i

        if i > 0:
            R_pi = R_stack[i]
            f_parent = _mv(R_pi, f_i)
            n = _mv(R_pi, n_i) + cross(model.j_pos[i].expand(batch + (3,)), f_parent)
            f = f_parent

    return torch.stack(tau, dim=-1)


def bias_forces(model: PandaModel, q, v):
    """b(q, v) = Coriolis + gravity + damping*v  (torque units, (...,7))."""
    return rnea(model, q, v, torch.zeros_like(q))


def gravity_torque(model: PandaModel, q):
    """tau_g(q) = rnea(q, 0, 0): gravity compensation torques."""
    z = torch.zeros_like(q)
    return rnea(model, q, z, z)


def mass_matrix(model: PandaModel, q):
    """Joint-space inertia matrix M(q) (..., 7, 7), including armature."""
    z = torch.zeros_like(q)
    eye = torch.eye(7, dtype=q.dtype, device=q.device)
    cols = torch.stack(
        [rnea(model, q, z, eye[j].expand(q.shape), gravity=False,
              joint_terms=False) for j in range(7)], dim=-1)      # (..., 7, 7)
    return cols + torch.diag(model.armature)


def mass_matrix_fk(model: PandaModel, q, fk_res: Optional[FKResult] = None):
    """Joint-space inertia via the world-frame Jacobian formulation,
    reusing FK:  M = sum_i [ m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i ]
    + diag(armature).

    Equivalent to ``mass_matrix`` (7x RNEA columns) but with no sequential
    recursion: every term is a masked batched cross product / small matmul
    over the already-computed FK.
    """
    f = fk_res if fk_res is not None else fk(model, q)
    dtype = q.dtype
    batch = q.shape[:-1]

    c_w = f.p + torch.einsum("...iab,ib->...ia", f.R, model.com)   # (...,7,3)
    I_w = torch.einsum("...iab,ibc,...idc->...iad", f.R, model.inertia, f.R)

    # Jv[i, j] = axis_j x (com_i - p_j) for j <= i; Jw[i, j] = axis_j
    r = c_w[..., :, None, :] - f.p[..., None, :, :]              # (...,7i,7j,3)
    axis = f.axis_w[..., None, :, :].expand(batch + (7, 7, 3))
    mask = torch.as_tensor(np.tril(np.ones((7, 7))), dtype=dtype,
                           device=q.device)[..., None]
    Jv = torch.linalg.cross(axis, r) * mask
    Jw = axis * mask

    M = (torch.einsum("i,...ija,...ika->...jk", model.mass, Jv, Jv)
         + torch.einsum("...ija,...iab,...ikb->...jk", Jw, I_w, Jw))
    return M + torch.diag(model.armature)


def fwd_dynamics_free(model: PandaModel, q, v, tau, fk_res: Optional[FKResult] = None):
    """Free-space forward dynamics a = M^{-1}(tau - b).  (..., 7) each."""
    M = mass_matrix_fk(model, q, fk_res)
    b = bias_forces(model, q, v)
    return spd_solve(M, tau - b)


class ContactDynOut(NamedTuple):
    acc: torch.Tensor    # (..., 7)
    force: torch.Tensor  # (..., nc) contact force along the constrained axes
    fk_res: FKResult     # kinematics reused by residuals


class FreeDynDerivs(NamedTuple):
    acc: torch.Tensor     # (..., 7)
    da_dx: torch.Tensor   # (..., 7, 14) d(acc)/d(q,v)
    da_du: torch.Tensor   # (..., 7, 7)  d(acc)/d(tau) = M^{-1}
    fk_res: FKResult


class ContactDynDerivs(NamedTuple):
    acc: torch.Tensor     # (..., 7)
    force: torch.Tensor   # (..., nc)
    da_dx: torch.Tensor   # (..., 7, 14)
    df_dx: torch.Tensor   # (..., nc, 14)
    da_du: torch.Tensor   # (..., 7, 7)
    df_du: torch.Tensor   # (..., nc, 7)
    fk_res: FKResult
    extras_jac: Any       # d(extra_q_fn)/dq pytree, or None


def _eye_like(n, ref):
    return torch.eye(n, dtype=ref.dtype, device=ref.device).expand(
        ref.shape[:-1] + (n, n))


def free_dynamics_derivs(model: PandaModel, q, v, tau) -> FreeDynDerivs:
    """Free forward dynamics + analytic first derivatives, batched.

    Uses the inverse-dynamics trick (Carpentier & Mansard, RSS 2018): with
    a* = M^{-1}(tau - b) fixed, RNEA(q, v, a*) = M(q) a* + b(q, v), so

        d(acc)/d(q,v) = -M^{-1} * d RNEA(q, v, a*)/d(q,v),   d(acc)/dtau = M^{-1}.
    """
    fk_res = fk(model, q)
    M = mass_matrix_fk(model, q, fk_res)
    b = bias_forces(model, q, v)
    L = chol_factor(M)
    acc = chol_solve(L, tau - b)

    # acc enters via closure: constant w.r.t. the differentiation variable
    G1q = jac_last(lambda qq: rnea(model, qq, v, acc), q)
    G1v = jac_last(lambda vv: rnea(model, q, vv, acc), v)
    da_dx = -chol_solve(L, torch.cat([G1q, G1v], dim=-1))
    da_du = chol_solve(L, _eye_like(7, q))
    return FreeDynDerivs(acc=acc, da_dx=da_dx, da_du=da_du, fk_res=fk_res)


def _contact_gap(fk_res: FKResult, ref_pos, nc1: bool):
    if nc1:
        # ref_pos: (...,) world-z target -> broadcast against (..., 1)
        return fk_res.ee_p[..., 2:3] - ref_pos[..., None]
    return fk_res.ee_p - ref_pos


def contact_dynamics_derivs(model: PandaModel, q, v, tau, *,
                            ref_pos, nc1: bool = True,
                            baumgarte_kp: float = 0.0, baumgarte_kd: float = 0.0,
                            damping_c: float = 1.0e-8,
                            extra_q_fn=None) -> ContactDynDerivs:
    """Damped-KKT contact dynamics + analytic first derivatives, batched.

    The solution (a, f) of the damped KKT system satisfies

        g1(q, v, tau; a, f) = RNEA(q, v, a) - Jc(q)^T f - tau           = 0
        h2(q, v;     a, f) = Jc(q) a + gamma(q, v) + kp*gap + kd*Jc v + c f = 0

    Implicit function theorem: [M, -Jc^T; Jc, cI] [da; df] = -[dg1; dh2]
    with dg1/dh2 evaluated at FIXED (a, f): one RNEA + contact-row sweep
    under forward tangents, then re-solves against the already factored M
    and Schur complement S = Jc M^{-1} Jc^T + cI.

    ``ref_pos``: tensor (...,) for the 1D contact, (..., 3) for the 3D one.
    ``extra_q_fn(qq, fk2) -> pytree``: optional extra q-dependent outputs
    evaluated inside the q-sweep so their Jacobians share the FK tangent
    computation; d/dq comes back in ``extras_jac``.
    """
    fk_res = fk(model, q)
    Jc, gamma = _contact_rows(model, q, v, nc1, fk_res)
    nc = Jc.shape[-2]
    JcT = Jc.transpose(-1, -2)

    M = mass_matrix_fk(model, q, fk_res)
    b = bias_forces(model, q, v)
    L = chol_factor(M)

    vel_c = _mv(Jc, v)
    gap = _contact_gap(fk_res, ref_pos, nc1)
    a_des = -gamma - baumgarte_kp * gap - baumgarte_kd * vel_c

    Minv_tau = chol_solve(L, tau - b)
    Minv_Jt = chol_solve(L, JcT)                                  # (..., 7, nc)
    S = Jc @ Minv_Jt + damping_c * torch.eye(nc, dtype=q.dtype, device=q.device)
    LS = chol_factor(S)
    f = chol_solve(LS, a_des - _mv(Jc, Minv_tau))                 # (..., nc)
    acc = Minv_tau + _mv(Minv_Jt, f)

    def kkt_q(qq):
        fk2 = fk(model, qq)
        Jc2, gamma2 = _contact_rows(model, qq, v, nc1, fk2)
        g1 = rnea(model, qq, v, acc) - _mv(Jc2.transpose(-1, -2), f)
        gap2 = _contact_gap(fk2, ref_pos, nc1)
        h2 = (_mv(Jc2, acc) + gamma2 + baumgarte_kp * gap2
              + baumgarte_kd * _mv(Jc2, v))
        if extra_q_fn is None:
            return g1, h2
        return g1, h2, extra_q_fn(qq, fk2)

    jac_q = jac_last(kkt_q, q)
    G1q, H2q = jac_q[0], jac_q[1]
    extras_jac = jac_q[2] if extra_q_fn is not None else None
    G1v, H2v = _kkt_v_jac(model, q, v, acc, Jc, nc1, baumgarte_kd)
    G1 = torch.cat([G1q, G1v], dim=-1)                            # (..., 7, 14)
    H2 = torch.cat([H2q, H2v], dim=-1)                            # (..., nc, 14)

    df_dx = chol_solve(LS, Jc @ chol_solve(L, G1) - H2)
    da_dx = chol_solve(L, -G1 + JcT @ df_dx)

    df_du = -chol_solve(LS, Minv_Jt.transpose(-1, -2))   # -S^{-1} Jc M^{-1}
    da_du = chol_solve(L, _eye_like(7, q)) + Minv_Jt @ df_du
    return ContactDynDerivs(acc=acc, force=f, da_dx=da_dx, df_dx=df_dx,
                            da_du=da_du, df_du=df_du, fk_res=fk_res,
                            extras_jac=extras_jac)


def _kkt_v_jac(model: PandaModel, q, v, acc, Jc, nc1: bool, kd: float):
    """d(g1, h2)/dv at fixed (q, acc, f): RNEA velocity terms + drift.

    gamma(q, vv) = (dJ/dq . vv) vv is bilinear in vv; its v-Jacobian flows
    through both slots of the defining jvp.  FK primals are constants here.
    """

    def g1_of(vv):
        return rnea(model, q, vv, acc)

    def h2_of(vv):
        def linvel(qq):
            Jp2, _ = ee_jacobian(model, qq, fk_res=fk(model, qq))
            Jc2 = Jp2[..., 2:3, :] if nc1 else Jp2
            return _mv(Jc2, vv)

        _, gamma2 = torch.func.jvp(linvel, (q,), (vv,))
        return gamma2 + kd * _mv(Jc, vv)

    return jac_last(g1_of, v), jac_last(h2_of, v)


def _contact_rows(model: PandaModel, q, v, nc1: bool, fk_res: FKResult):
    """Contact Jacobian rows and their drift (Jdot*v) at the ee frame.

    nc1=True  -> 1D normal contact along world z.
    nc1=False -> 3D point contact.
    Returns (Jc (..., nc, 7), gamma (..., nc) = d(J v)/dt at fixed v).
    """
    J_pos, _ = ee_jacobian(model, q, fk_res=fk_res)

    # drift a0 = d/dt (J(q) v) |_{qdd=0} = (dJ/dq qdot) v : jvp of J v wrt q.
    def linvel(qq):
        Jp, _ = ee_jacobian(model, qq, fk_res=fk(model, qq))
        return _mv(Jp, v)

    _, gamma3 = torch.func.jvp(linvel, (q,), (v,))

    if nc1:
        return J_pos[..., 2:3, :], gamma3[..., 2:3]
    return J_pos, gamma3


def fwd_dynamics_contact(model: PandaModel, q, v, tau, *,
                         ref_pos, nc1: bool = True,
                         baumgarte_kp: float = 0.0, baumgarte_kd: float = 0.0,
                         damping_c: float = 1.0e-8):
    """Constrained forward dynamics with a damped-KKT ee contact.

    ``ref_pos``: the contact reference: world-z height (...,) for the 1D
    model or the anchor point (..., 3) for the 3D model.  Baumgarte gains
    (kp, kd): corrective acceleration -kp*gap - kd*vel added to the
    constraint RHS.

    Sign convention: ``force`` is the force applied BY the environment ON the
    ee along the constrained axes (world z for 1D).
    """
    fk_res = fk(model, q)
    Jc, gamma = _contact_rows(model, q, v, nc1, fk_res)
    nc = Jc.shape[-2]

    M = mass_matrix_fk(model, q, fk_res)
    b = bias_forces(model, q, v)
    L = chol_factor(M)

    vel_c = _mv(Jc, v)
    gap = _contact_gap(fk_res, ref_pos, nc1)
    a_des = -gamma - baumgarte_kp * gap - baumgarte_kd * vel_c

    Minv_tau = chol_solve(L, tau - b)
    Minv_Jt = chol_solve(L, Jc.transpose(-1, -2))
    S = Jc @ Minv_Jt + damping_c * torch.eye(nc, dtype=q.dtype, device=q.device)

    # lambda = (J M^-1 J^T + cI)^{-1} (a_des - J M^-1 (tau - b)):
    # the constraint force ON the robot (positive = table pushes the ee up).
    f = spd_solve(S, a_des - _mv(Jc, Minv_tau))                  # (..., nc)

    acc = Minv_tau + _mv(Minv_Jt, f)
    return ContactDynOut(acc=acc, force=f, fk_res=fk_res)
