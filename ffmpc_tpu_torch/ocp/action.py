"""Discrete action models (knots) with Gauss-Newton derivatives.

PyTorch counterpart of ``ffmpc_tpu/ocp/action.py``, vector/analytic form,
batched natively: every knot function takes tensors with arbitrary leading
batch dims (a single knot slice of ``ProblemRefs``, states (..., nx),
controls (..., nu)).

Ported so far, both with either contact model of the JAX package: the 1-D
normal contact (``contact_model="normal_1d"``, force in R^1) and the 3-D
point contact (``"point3d"``, force in R^3, with the linearized friction
cone's barrier on A f); any other name raises:
- the classical knot (``make_classical_knot``): state x=(q,v) in R^14,
  control u=tau in R^7, semi-implicit Euler over free or contact forward
  dynamics with the full cost stack;
- the augmented LPF knot (force-feedback, ``make_augmented_knot``): state
  y=(q,v,tau) in R^21, control w in R^7, with tau+ = alpha*tau + (1-alpha)*w
  and outer y/w regularization costs, on top of the classical inner knot.

Derivatives: dynamics Jacobians come from the KKT implicit-function theorem
(``core.dynamics``); cost Hessians are assembled Gauss-Newton style
(activation grad / diagonal Hessian; residual second derivatives dropped).
Cost scaling: running knot cost is dt * sum(inner costs); the augmented outer
costs are discrete-level (never dt-scaled); the classical terminal knot's
cost is unscaled (Crocoddyl's terminal overload), the augmented one keeps
the inner dt scale.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.panda import PandaModel
from ..core.dynamics import (fwd_dynamics_free, fwd_dynamics_contact,
                             free_dynamics_derivs, contact_dynamics_derivs,
                             jac_last)
from ..core.kinematics import fk, ee_jacobian
from ..core.smallchol import matvec as _mv
from ..core.spatial import log3
from . import activations as act
from .weights import OCPWeights, ProblemRefs


class CostTerm(NamedTuple):
    weight: float
    activation: act.Activation
    dt_scaled: bool         # True: running-knot cost is scaled by dt_ocp
    terminal: bool          # participates in the terminal knot


class KnotDeriv(NamedTuple):
    xnext: torch.Tensor   # (..., nx)
    cost: torch.Tensor    # (...,)
    Fx: torch.Tensor      # (..., nx, nx)
    Fu: torch.Tensor      # (..., nx, nu)
    Lx: torch.Tensor      # (..., nx)
    Lu: torch.Tensor      # (..., nu)
    Lxx: torch.Tensor     # (..., nx, nx)
    Lxu: torch.Tensor     # (..., nx, nu)
    Luu: torch.Tensor     # (..., nu, nu)


class KnotModel(NamedTuple):
    """Static bundle of knot callables consumed by the solver.

    calc:      (ref_k, x, u) -> (xnext, cost)
    diff:      (ref_k, x, u) -> KnotDeriv
    term_calc: (ref_T, x) -> cost
    term_diff: (ref_T, x) -> (cost, Lx, Lxx)
    """
    calc: Callable
    diff: Callable
    term_calc: Callable
    term_diff: Callable
    nx: int
    nu: int
    u_lb: Tuple[float, ...]
    u_ub: Tuple[float, ...]
    # what the knot was built from, for the rollout kernel's constant packer
    # (solver/rollout_cuda.py::pack_knot_consts)
    model: Optional[PandaModel] = None
    W: Optional[OCPWeights] = None
    surface: Optional[bool] = None
    # "classical" or "augmented": the kernels' wrappers dispatch on it
    family: Optional[str] = None


# ---------------------------------------------------------------------------
# residual stacks
# ---------------------------------------------------------------------------

def _build_q_soft_barrier(model: PandaModel, margin: float):
    """Barrier bounds for the joint-limit soft cost: the residual is
    x - x_ref with x_ref = (q_mid, 0); bounds shrink by margin."""
    q_lb = model.q_lower.detach().cpu().numpy().astype(np.float64)
    q_ub = model.q_upper.detach().cpu().numpy().astype(np.float64)
    q_ref = 0.5 * (q_lb + q_ub)
    lb_q = (q_lb + margin) - q_ref
    ub_q = (q_ub - margin) - q_ref
    bad = lb_q > ub_q
    lb_q[bad] = -1.0e-3
    ub_q[bad] = 1.0e-3
    lb = np.concatenate([lb_q, np.full(7, -np.inf)])
    ub = np.concatenate([ub_q, np.full(7, np.inf)])
    x_ref = np.concatenate([q_ref, np.zeros(7)])
    return x_ref, lb, ub


def _friction_cone_A(mu: float):
    """Linearized 4-facet outer friction cone rows: A f >= 0 feasible."""
    return np.array([[-1.0, 0.0, mu],
                     [1.0, 0.0, mu],
                     [0.0, -1.0, mu],
                     [0.0, 1.0, mu]])


def contact_width(W: OCPWeights, surface: bool) -> int:
    """The contact force's width nc: 3 for the point contact on the
    surface, else 1 (free space has no force rows)."""
    return 3 if (surface and W.contact_model == "point3d") else 1


def _make_spec(model: PandaModel, W: OCPWeights, surface: bool):
    """Static cost-term spec: name -> CostTerm. Order fixes residual layout.
    The force rows are nc = ``contact_width(W, surface)`` wide."""
    nc = contact_width(W, surface)
    spec: Dict[str, CostTerm] = {}

    spec["posture"] = CostTerm(W.w_posture, act.quad(), True, True)
    spec["v_damp"] = CostTerm(
        W.w_v, act.wquad([0.0] * 7 + list(W.v_damp_weights)), True, True)
    if W.w_q_soft_limits > 0.0:
        _, lb, ub = _build_q_soft_barrier(model, W.q_soft_limit_margin)
        spec["q_soft_limits"] = CostTerm(W.w_q_soft_limits, act.barrier(lb, ub), True, True)
    spec["ee_ori"] = CostTerm(W.w_ee_ori, act.wquad(W.ori_weights), True, True)
    spec["w_damp"] = CostTerm(
        W.w_wdamp, act.wquad([0.0, 0.0, 0.0] + list(W.w_wdamp_weights)), True, True)

    # running-only control costs
    spec["tau_reg"] = CostTerm(W.w_tau, act.quad(), True, False)
    if W.w_tau_soft_limits > 0.0:
        tau_lim = np.asarray(W.tau_limits)
        margin = min(max(W.tau_soft_limit_margin, 0.0), float(tau_lim.min()) - 1e-6)
        spec["tau_soft_limits"] = CostTerm(
            W.w_tau_soft_limits, act.barrier(-tau_lim + margin, tau_lim - margin), True, False)

    if not surface:
        spec["ee_pos"] = CostTerm(W.w_ee_pos, act.wquad(W.ee_pos_weights), True, True)
    else:
        spec["ee_xy"] = CostTerm(W.w_tangent_pos, act.wquad([1.0, 1.0, 0.0]), True, True)
        spec["ee_vxy"] = CostTerm(
            W.w_tangent_vel, act.wquad([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]), True, True)
        if W.w_plane_z > 0.0:
            spec["plane_z"] = CostTerm(W.w_plane_z, act.wquad([0.0, 0.0, 1.0]), True, True)
        if W.w_vz > 0.0:
            spec["vz_damp"] = CostTerm(
                W.w_vz, act.wquad([0.0, 0.0, 1.0, 0.0, 0.0, 0.0]), True, True)
        if nc == 3 and W.w_friction_cone > 0.0:
            eps = max(W.friction_margin, 0.0)
            spec["friction_cone"] = CostTerm(
                W.w_friction_cone, act.barrier([eps] * 4, [np.inf] * 4), True, True)
        if W.w_unilateral > 0.0:
            if nc == 1:
                lb, ub = [W.friction_margin], [np.inf]
            else:
                lb = [-np.inf, -np.inf, W.friction_margin]
                ub = [np.inf, np.inf, np.inf]
            spec["unilateral"] = CostTerm(W.w_unilateral, act.barrier(lb, ub), True, True)
        if W.w_fn > 0.0:
            aw = [1.0] if nc == 1 else [0.0, 0.0, 1.0]
            spec["fn_track"] = CostTerm(W.w_fn, act.wquad(aw), True, True)

    return spec


def _press_point(W: OCPWeights, ref):
    """p_ref with its z lowered by the press depth: (..., 3)."""
    return torch.cat([ref.p_ref[..., :2],
                      ref.p_ref[..., 2:3] - W.z_press], dim=-1)


def _contact_ref_pos(W: OCPWeights, nc: int, ref):
    """The contact's reference: the world-z height (...,) for the 1-D
    contact, the anchor point (..., 3) (p_ref lowered by the press depth)
    for the 3-D one."""
    if nc == 1:
        return ref.p_ref[..., 2] - W.z_press
    return _press_point(W, ref)


def _residual_values(model: PandaModel, W: OCPWeights, surface: bool,
                     terminal: bool, ref, x, u, fk_res, vel6, force):
    """Residual dict for one classical knot from precomputed kinematics."""
    res: Dict[str, torch.Tensor] = {}
    res["posture"] = x - ref.x_reg_ref
    res["v_damp"] = x
    if W.w_q_soft_limits > 0.0:
        x_ref_np, _, _ = _build_q_soft_barrier(model, W.q_soft_limit_margin)
        res["q_soft_limits"] = x - torch.as_tensor(x_ref_np, dtype=x.dtype,
                                                   device=x.device)
    res["ee_ori"] = log3(ref.R_des.transpose(-1, -2) @ fk_res.ee_R)
    res["w_damp"] = vel6
    if not terminal:
        res["tau_reg"] = u - ref.tau_ref
        if W.w_tau_soft_limits > 0.0:
            res["tau_soft_limits"] = u
    if not surface:
        res["ee_pos"] = fk_res.ee_p - ref.p_ref
    else:
        res["ee_xy"] = fk_res.ee_p - ref.p_ref
        v_ref6 = torch.cat([ref.v_ref[..., :2],
                            torch.zeros_like(vel6[..., :4])], dim=-1)
        res["ee_vxy"] = vel6 - v_ref6
        if W.w_plane_z > 0.0:
            res["plane_z"] = fk_res.ee_p - _press_point(W, ref)
        if W.w_vz > 0.0:
            res["vz_damp"] = vel6
        nc = contact_width(W, surface)
        if nc == 3 and W.w_friction_cone > 0.0:
            A = torch.as_tensor(_friction_cone_A(W.mu), dtype=x.dtype, device=x.device)
            res["friction_cone"] = _mv(A, force)
        if W.w_unilateral > 0.0:
            res["unilateral"] = force
        if W.w_fn > 0.0:
            if nc == 1:
                res["fn_track"] = force - W.fn_des
            else:
                fn_ref = torch.tensor([0.0, 0.0, W.fn_des], dtype=x.dtype, device=x.device)
                res["fn_track"] = force - fn_ref

    return res


def _classical_raw(model: PandaModel, W: OCPWeights, surface: bool,
                   terminal: bool, ref, x, u):
    """xnext + residual dict for one classical knot. x: (..., 14), u: (..., 7)."""
    dt = float(W.dt_ocp)
    nc = contact_width(W, surface)
    q, v = x[..., :7], x[..., 7:]

    if surface:
        dyn = fwd_dynamics_contact(
            model, q, v, u, ref_pos=_contact_ref_pos(W, nc, ref), nc1=nc == 1,
            baumgarte_kp=W.contact_gains[0], baumgarte_kd=W.contact_gains[1],
            damping_c=W.contact_inv_damping)
        acc, force, fk_res = dyn.acc, dyn.force, dyn.fk_res
    else:
        fk_res = fk(model, q)
        acc = fwd_dynamics_free(model, q, v, u, fk_res=fk_res)
        force = None

    v_next = v + dt * acc
    q_next = q + dt * v_next
    xnext = torch.cat([q_next, v_next], dim=-1)

    Jp, Jr = ee_jacobian(model, q, fk_res=fk_res)
    vel6 = torch.cat([_mv(Jp, v), _mv(Jr, v)], dim=-1)

    res = _residual_values(model, W, surface, terminal, ref, x, u,
                           fk_res, vel6, force)
    return xnext, res


def _assemble_cost(spec, res, dt_scale: float, terminal: bool):
    """Sum weighted activations.  ``dt_scale`` multiplies dt_scaled terms."""
    cost = 0.0
    for name, term in spec.items():
        if terminal and not term.terminal:
            continue
        scale = dt_scale if term.dt_scaled else 1.0
        cost = cost + term.weight * scale * act.value(term.activation, res[name])
    return cost


def _assemble_gn(spec, res, Jx, Ju, dt_scale: float, terminal: bool,
                 nx: int, nu: int, like: torch.Tensor):
    """Gauss-Newton assembly.  Jx/Ju: dicts of residual Jacobians
    (..., nr, nx) / (..., nr, nu); a missing or ``None`` entry means an
    exactly-zero Jacobian.  ``like``: a (..., nx) tensor fixing batch shape,
    dtype and device."""
    batch = like.shape[:-1]
    kw = dict(dtype=like.dtype, device=like.device)
    Lx = torch.zeros(batch + (nx,), **kw)
    Lxx = torch.zeros(batch + (nx, nx), **kw)
    Lu = torch.zeros(batch + (nu,), **kw)
    Luu = torch.zeros(batch + (nu, nu), **kw)
    Lxu = torch.zeros(batch + (nx, nu), **kw)
    cost = torch.zeros(batch, **kw)
    with_u = Ju is not None and not terminal

    for name, term in spec.items():
        if terminal and not term.terminal:
            continue
        r = res[name]
        s = term.weight * (dt_scale if term.dt_scaled else 1.0)
        g = act.grad(term.activation, r)
        h = act.hess_diag(term.activation, r)
        jx = Jx.get(name)
        ju = Ju.get(name) if with_u else None
        cost = cost + s * act.value(term.activation, r)
        if jx is not None:
            jxT = jx.transpose(-1, -2)
            Lx = Lx + s * _mv(jxT, g)
            Lxx = Lxx + s * (jxT @ (h[..., None] * jx))
        if ju is not None:
            juT = ju.transpose(-1, -2)
            Lu = Lu + s * _mv(juT, g)
            Luu = Luu + s * (juT @ (h[..., None] * ju))
            if jx is not None:
                Lxu = Lxu + s * (jx.transpose(-1, -2) @ (h[..., None] * ju))
    return cost, Lx, Lu, Lxx, Lxu, Luu


def _classical_analytic(model: PandaModel, W: OCPWeights, surface: bool,
                        terminal: bool, ref, x, u):
    """Knot forward + analytic derivatives: (xnext, res, Jx, Ju, Fx, Fu).

    Dynamics derivatives come from the KKT implicit-function theorem
    (core.dynamics.free_dynamics_derivs / contact_dynamics_derivs); residual
    Jacobians are assembled from the frame Jacobian (d ee_p/dq == J_pos
    exactly) plus one 7-tangent forward sweep through the FK-only chain for
    the orientation log-map and the dJ/dq·v velocity term."""
    dt = float(W.dt_ocp)
    nc = contact_width(W, surface)
    q, v = x[..., :7], x[..., 7:]
    batch = x.shape[:-1]
    kw = dict(dtype=x.dtype, device=x.device)

    def kin_of(qq, fk2):
        """Cost-residual kinematics (q-dependent parts): shared with the
        dynamics q-sweep so FK tangents are computed once."""
        Jp2, Jr2 = ee_jacobian(model, qq, fk_res=fk2)
        ori = log3(ref.R_des.transpose(-1, -2) @ fk2.ee_R)
        vel62 = torch.cat([_mv(Jp2, v), _mv(Jr2, v)], dim=-1)
        return ori, vel62

    if surface:
        dd = contact_dynamics_derivs(
            model, q, v, u, ref_pos=_contact_ref_pos(W, nc, ref), nc1=nc == 1,
            baumgarte_kp=W.contact_gains[0], baumgarte_kd=W.contact_gains[1],
            damping_c=W.contact_inv_damping, extra_q_fn=kin_of)
        acc, force, fk_res = dd.acc, dd.force, dd.fk_res
        da_dx, da_du, df_dx, df_du = dd.da_dx, dd.da_du, dd.df_dx, dd.df_du
        dori_dq, dvel6_dq = dd.extras_jac
    else:
        fd = free_dynamics_derivs(model, q, v, u)
        acc, fk_res = fd.acc, fd.fk_res
        da_dx, da_du = fd.da_dx, fd.da_du
        force = df_dx = df_du = None
        dori_dq, dvel6_dq = jac_last(lambda qq: kin_of(qq, fk(model, qq)), q)

    v_next = v + dt * acc
    q_next = q + dt * v_next
    xnext = torch.cat([q_next, v_next], dim=-1)

    # semi-implicit Euler chain rule (v+ = v + dt*a; q+ = q + dt*v+)
    I7 = torch.eye(7, **kw).expand(batch + (7, 7))
    Aq, Av = da_dx[..., :, :7], da_dx[..., :, 7:]
    Fx = torch.cat([
        torch.cat([I7 + (dt * dt) * Aq, dt * I7 + (dt * dt) * Av], dim=-1),
        torch.cat([dt * Aq, I7 + dt * Av], dim=-1),
    ], dim=-2)
    Fu = torch.cat([(dt * dt) * da_du, dt * da_du], dim=-2)

    Jp, Jr = ee_jacobian(model, q, fk_res=fk_res)
    vel6 = torch.cat([_mv(Jp, v), _mv(Jr, v)], dim=-1)

    res = _residual_values(model, W, surface, terminal, ref, x, u,
                           fk_res, vel6, force)

    Z37 = torch.zeros(batch + (3, 7), **kw)
    eye14 = torch.eye(14, **kw).expand(batch + (14, 14))
    J_ori = torch.cat([dori_dq, Z37], dim=-1)                  # (..., 3, 14)
    J_vel6 = torch.cat([dvel6_dq, torch.cat([Jp, Jr], dim=-2)], dim=-1)
    J_pos14 = torch.cat([Jp, Z37], dim=-1)                     # (..., 3, 14)

    Jx: Dict[str, torch.Tensor] = {
        "posture": eye14, "v_damp": eye14,
        "ee_ori": J_ori, "w_damp": J_vel6,
    }
    Ju: Dict[str, torch.Tensor] = {}
    if W.w_q_soft_limits > 0.0:
        Jx["q_soft_limits"] = eye14
    if not terminal:
        Ju["tau_reg"] = I7
        if W.w_tau_soft_limits > 0.0:
            Ju["tau_soft_limits"] = I7
    if not surface:
        Jx["ee_pos"] = J_pos14
    else:
        Jx["ee_xy"] = J_pos14
        Jx["ee_vxy"] = J_vel6
        if W.w_plane_z > 0.0:
            Jx["plane_z"] = J_pos14
        if W.w_vz > 0.0:
            Jx["vz_damp"] = J_vel6
        if nc == 3 and W.w_friction_cone > 0.0:
            A = torch.as_tensor(_friction_cone_A(W.mu), **kw)
            Jx["friction_cone"] = A @ df_dx
            Ju["friction_cone"] = A @ df_du
        if W.w_unilateral > 0.0:
            Jx["unilateral"] = df_dx
            Ju["unilateral"] = df_du
        if W.w_fn > 0.0:
            Jx["fn_track"] = df_dx
            Ju["fn_track"] = df_du

    return xnext, res, Jx, Ju, Fx, Fu


# ---------------------------------------------------------------------------
# classical knot
# ---------------------------------------------------------------------------

CONTACT_MODELS = ("normal_1d", "point3d")


def _check_contact_model(W: OCPWeights):
    if W.contact_model not in CONTACT_MODELS:
        raise ValueError(
            f"contact_model {W.contact_model!r}: expected one of {CONTACT_MODELS}")


def make_classical_knot(model: PandaModel, W: OCPWeights,
                        surface: bool) -> KnotModel:
    """Classical action model on x=(q,v), control u=tau: semi-implicit Euler
    over the free or contact forward dynamics, the spec's costs scaled by dt
    on running knots; the terminal knot takes u = 0 and its terms unscaled.
    Device and dtype follow ``model``'s tensors and the inputs."""
    _check_contact_model(W)
    spec = _make_spec(model, W, surface)
    nx, nu = 14, 7
    dt = float(W.dt_ocp)

    def calc(ref, x, u):
        xnext, res = _classical_raw(model, W, surface, False, ref, x, u)
        return xnext, _assemble_cost(spec, res, dt, False)

    def diff(ref, x, u):
        xnext, res, Jx, Ju, Fx, Fu = _classical_analytic(
            model, W, surface, False, ref, x, u)
        cost, Lx, Lu, Lxx, Lxu, Luu = _assemble_gn(
            spec, res, Jx, Ju, dt, False, nx, nu, x)
        return KnotDeriv(xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu)

    def term_calc(ref, x):
        u0 = torch.zeros_like(x[..., :nu])
        _, res = _classical_raw(model, W, surface, True, ref, x, u0)
        return _assemble_cost(spec, res, 1.0, True)

    def term_diff(ref, x):
        u0 = torch.zeros_like(x[..., :nu])
        _, res, Jx, _, _, _ = _classical_analytic(model, W, surface, True, ref, x, u0)
        cost, Lx, _, Lxx, _, _ = _assemble_gn(
            spec, res, Jx, None, 1.0, True, nx, nu, x)
        return cost, Lx, Lxx

    lim = tuple(float(t) for t in W.tau_limits)
    return KnotModel(calc, diff, term_calc, term_diff, nx, nu,
                     tuple(-t for t in lim), lim, model, W, surface, "classical")


# ---------------------------------------------------------------------------
# augmented LPF knot (force-feedback)
# ---------------------------------------------------------------------------

def lpf_coefficients(W: OCPWeights):
    """(alpha, 1 - alpha) of the torque filter tau+ = alpha tau + (1-alpha) w."""
    alpha = float(np.clip(W.ff_alpha, 0.0, 0.999999))
    return alpha, 1.0 - alpha


def augmented_spec(model: PandaModel, W: OCPWeights, surface: bool):
    """The augmented knot's cost terms in summation order (the inner spec
    without the disabled inner regularizations, then the discrete-level
    y / w terms), and the names of the dropped inner terms."""
    spec = dict(_make_spec(model, W, surface))
    dropped = []
    if not W.use_inner_state_reg:
        dropped += ["posture", "v_damp"]
    if not W.use_inner_tau_reg:
        dropped += ["tau_reg", "tau_soft_limits"]
    for name in dropped:
        spec.pop(name, None)

    w_lim = np.asarray(W.tau_limits)
    soft_lim = np.maximum(w_lim - max(W.tau_soft_limit_margin, 0.0), 1e-9)
    outer_spec: Dict[str, CostTerm] = {}
    if W.w_y > 0.0:
        wy2 = [float(v) ** 2 for v in W.y_weights]
        outer_spec["y_reg"] = CostTerm(W.w_y, act.wquad(wy2), False, True)
    if W.w_w > 0.0:
        outer_spec["w_reg"] = CostTerm(W.w_w, act.quad(), False, True)
    if W.w_w_soft_limits > 0.0:
        outer_spec["w_soft"] = CostTerm(
            W.w_w_soft_limits, act.barrier(-soft_lim, soft_lim), False, True)
    return {**spec, **outer_spec}, dropped


def make_augmented_knot(model: PandaModel, W: OCPWeights,
                        surface: bool) -> KnotModel:
    """Augmented action model on y=(q,v,tau), control w.

    y+ = [EulerKnot(x, tau); alpha*tau + (1-alpha)*w]; costs = inner knot cost
    (dt-scaled) + discrete-level y-reg, w-reg, w-soft-limit terms.
    Device and dtype follow ``model``'s tensors and the inputs.
    """
    _check_contact_model(W)
    full_spec, _dropped = augmented_spec(model, W, surface)

    nx, nu, nx_mb = 21, 7, 14
    dt = float(W.dt_ocp)
    alpha, beta = lpf_coefficients(W)

    def _outer_residuals(res, ref, y, w):
        if W.w_y > 0.0:
            res["y_reg"] = y - ref.y_ref
        if W.w_w > 0.0:
            res["w_reg"] = w
        if W.w_w_soft_limits > 0.0:
            res["w_soft"] = w

    def raw(ref, y, w, terminal: bool):
        x_mb = y[..., :nx_mb]
        tau = y[..., nx_mb:]
        xnext_mb, res = _classical_raw(model, W, surface, terminal, ref, x_mb, tau)
        for name in _dropped:
            res.pop(name, None)
        tau_next = alpha * tau + beta * w
        ynext = torch.cat([xnext_mb, tau_next], dim=-1)
        _outer_residuals(res, ref, y, w)
        return ynext, res

    def calc(ref, y, w):
        ynext, res = raw(ref, y, w, False)
        return ynext, _assemble_cost(full_spec, res, dt, False)

    def _aug_analytic(ref, y, w, terminal: bool):
        """Inner classical analytic pieces lifted to y=(x_mb, tau), u=w.

        Fy = [[Fx_in, Fu_in], [0, alpha I]], Fw = [[0], [(1-alpha) I]];
        inner residual Jacobians gain a tau column-block (the inner control
        is the tau state), w appears only in the outer costs."""
        batch = y.shape[:-1]
        kw = dict(dtype=y.dtype, device=y.device)
        x_mb = y[..., :nx_mb]
        tau = y[..., nx_mb:]
        xnext_mb, res, Jx_in, Ju_in, Fx_in, Fu_in = _classical_analytic(
            model, W, surface, terminal, ref, x_mb, tau)
        for name in _dropped:
            res.pop(name, None)
            Jx_in.pop(name, None)
            Ju_in.pop(name, None)
        tau_next = alpha * tau + beta * w
        ynext = torch.cat([xnext_mb, tau_next], dim=-1)

        I7 = torch.eye(nu, **kw).expand(batch + (nu, nu))
        Z7x14 = torch.zeros(batch + (nu, nx_mb), **kw)
        Fy = torch.cat([
            torch.cat([Fx_in, Fu_in], dim=-1),
            torch.cat([Z7x14, alpha * I7], dim=-1),
        ], dim=-2)
        Fw = torch.cat([torch.zeros(batch + (nx_mb, nu), **kw), beta * I7],
                       dim=-2)

        Jy: Dict[str, torch.Tensor] = {}
        for name in res:
            jx = Jx_in.get(name)
            ju = Ju_in.get(name)
            if jx is None and ju is None:
                continue
            nr = res[name].shape[-1]
            jx = jx if jx is not None else torch.zeros(batch + (nr, nx_mb), **kw)
            ju = ju if ju is not None else torch.zeros(batch + (nr, nu), **kw)
            Jy[name] = torch.cat([jx, ju], dim=-1)
        Jw: Dict[str, torch.Tensor] = {}
        _outer_residuals(res, ref, y, w)
        if W.w_y > 0.0:
            Jy["y_reg"] = torch.eye(nx, **kw).expand(batch + (nx, nx))
        if W.w_w > 0.0:
            Jw["w_reg"] = I7
        if W.w_w_soft_limits > 0.0:
            Jw["w_soft"] = I7
        return ynext, res, Jy, Jw, Fy, Fw

    def diff(ref, y, w):
        ynext, res, Jy, Jw, Fy, Fw = _aug_analytic(ref, y, w, False)
        cost, Lx, Lu, Lxx, Lxu, Luu = _assemble_gn(
            full_spec, res, Jy, Jw, dt, False, nx, nu, y)
        return KnotDeriv(ynext, cost, Fy, Fw, Lx, Lu, Lxx, Lxu, Luu)

    def term_calc(ref, y):
        w0 = torch.zeros_like(y[..., :nu])
        _, res = raw(ref, y, w0, True)
        # terminal: the augmented model calls the inner running calc, so the
        # inner costs keep their dt scale; outer costs as-is.
        return _assemble_cost(full_spec, res, dt, True)

    def term_diff(ref, y):
        w0 = torch.zeros_like(y[..., :nu])
        _, res, Jy, _, _, _ = _aug_analytic(ref, y, w0, True)
        cost, Lx, _, Lxx, _, _ = _assemble_gn(
            full_spec, res, Jy, None, dt, True, nx, nu, y)
        return cost, Lx, Lxx

    lim = tuple(float(t) for t in W.tau_limits)
    return KnotModel(calc, diff, term_calc, term_diff, nx, nu,
                     tuple(-t for t in lim), lim, model, W, surface, "augmented")
