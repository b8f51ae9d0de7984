"""Batched FDDP / BoxFDDP.

PyTorch counterpart of ``ffmpc_tpu/solver/fddp.py``: the feasibility-driven
DDP algorithm (Mastalli et al., ICRA 2020) with Crocoddyl's semantics:

- feasibility gaps fs[0] = x0 - xs[0], fs[t+1] = f(xs[t], us[t]) - xs[t+1];
  the backward pass deflects Vx along the gaps, the forward pass keeps
  (1 - alpha)-scaled gaps open.
- Levenberg-Marquardt regularization schedule (inc/dec factor 10, bounds
  [1e-9, 1e9]) with backward-pass retry on an indefinite Quu.
- Goldstein-style acceptance with the gap-aware expected improvement
  d1 = dg + dv, d2 = dq - 2 dv, and negative-improvement acceptance
  (th_acceptnegstep) that lets pure gap-contraction steps through.
- BoxFDDP: control bounds via a projected-Newton box QP per knot; gain rows
  of clamped dimensions are zeroed and rollout controls are clamped.

Where the JAX package batches a single-problem ``solve`` with ``vmap``, this
module writes the batch dimension out: every tensor carries a leading B, and
the per-problem control flow that ``vmap`` of a ``while_loop`` gives is
spelled with masks: the backward retry recomputes only for problems whose
sweep went non-finite and keeps the others' outputs; a finished problem
(iteration budget, converged or diverged) freezes its whole carry while the
rest of the batch goes on.  State spaces are Euclidean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ocp.action import KnotModel
from ..ocp.weights import ProblemRefs
from .backward_cuda import backward_box, backward_box_reference
from .diff_cuda import KnotDerivs, diff_all, diff_reference
from .rollout_cuda import (consts_len, contact_of, family_of, pack_knot_consts, rollout,
                           rollout_reference)

KGAIN_REG = 1e-12


@dataclass(frozen=True)
class FDDPSettings:
    max_iters: int = 10
    n_alphas: int = 10          # alphas = 2^0 .. 2^-(n-1)
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc: float = 10.0
    reg_dec: float = 10.0
    th_acceptstep: float = 0.1
    th_acceptnegstep: float = 2.0
    th_stop: float = 1e-9
    th_grad: float = 1e-12
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    boxqp_iters: int = 8        # the backward pass is always box-constrained
    # bound on cost increases accepted through the gap-contraction branch
    # (see acceptance comment in the line search)
    neg_step_cost_factor: float = 1.2
    neg_step_cost_slack: float = 10.0
    # "kernel": the backward sweep goes through ``backward_box`` (the CUDA
    # kernel for tensors on the card); "plain": the batched PyTorch loop over
    # knots, ``backward_box_reference``.
    backward_mode: str = "kernel"
    # "kernel": the line-search rollout goes through ``rollout`` (the CUDA
    # kernel for tensors on the card); "plain": ``rollout_reference``, the
    # Python loop over knots of batched knot calcs.
    rollout_mode: str = "kernel"
    # "kernel": the derivative pass goes through ``diff_all`` (the CUDA
    # kernel for tensors on the card); "plain": ``diff_reference``, the
    # knot's batched diff and term_diff.
    diff_mode: str = "kernel"


class FDDPResult(NamedTuple):
    xs: torch.Tensor        # (B, N+1, nx)
    us: torch.Tensor        # (B, N, nu)
    K: torch.Tensor         # (B, N, nu, nx) Riccati feedback gains
    k: torch.Tensor         # (B, N, nu) feedforward (crocoddyl sign: u_try = u - a*k - K dx)
    cost: torch.Tensor      # (B,) total cost of the returned trajectory
    stop: torch.Tensor      # (B,) sum ||Qu||^2 (crocoddyl stoppingCriteria)
    iters: torch.Tensor     # (B,) int32 iterations actually performed
    converged: torch.Tensor # (B,) bool
    diverged: torch.Tensor  # (B,) bool (regularization blew past reg_max)
    feasible: torch.Tensor  # (B,) bool gaps closed
    xreg: torch.Tensor      # (B,) final regularization
    # (B, max_iters) step length accepted at each iteration, 0 where every
    # step length was rejected or the iteration did not run.  Not a field of
    # the JAX result: whole solves at float32 are compared by their decisions,
    # and this is the per-iteration one.
    alpha_hist: torch.Tensor


class _Carry(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    cost: torch.Tensor
    feasible: torch.Tensor
    xreg: torch.Tensor
    ureg: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    K: torch.Tensor
    kff: torch.Tensor
    stop: torch.Tensor
    alpha_hist: torch.Tensor


def _compute_gaps(x0, xs, xnexts):
    fs0 = (x0 - xs[:, 0])[:, None]
    return torch.cat([fs0, xnexts - xs[:, 1:]], dim=1)


def _select(pred, new, old):
    """Per-problem select: ``new`` where pred (B,), else ``old``."""
    return torch.where(pred.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class LineSearchStep(NamedTuple):
    """The step one iteration's line search takes, per problem."""
    accepted: torch.Tensor   # (B,) bool, some step length passed
    alpha: torch.Tensor      # (B,) the largest passing step length (1 where none passed)
    xs: torch.Tensor         # (B, N+1, nx) its trajectory, or the current one
    us: torch.Tensor         # (B, N, nu)
    cost: torch.Tensor       # (B,) its cost, or the current one


def accept_step(S: "FDDPSettings", xs, us, cost_cur, xs_try, us_try, cost_try,
                dv, dg, dq) -> LineSearchStep:
    """Acceptance of every step length and selection of the largest that
    passes (Crocoddyl's first-acceptable descending sweep with fixed cost).
    xs / us / cost_cur: the current iterate; xs_try, us_try, cost_try, dv:
    ``rollout``'s outputs (dv (B, A), the gap-aware expected improvement's
    gap sum -sum w_all (xs - xs_try), formed by the rollout); dg, dq: the
    backward sweep's expected-improvement terms."""
    B, A = cost_try.shape
    alphas = 0.5 ** torch.arange(A, dtype=xs.dtype, device=xs.device)
    dV = cost_cur[:, None] - cost_try                       # (B, A)
    d1 = dg[:, None] + dv
    d2 = dq[:, None] - 2.0 * dv
    dVexp = alphas * (d1 + 0.5 * alphas * d2)
    finite = torch.isfinite(cost_try)
    cost_guard = (S.neg_step_cost_factor * cost_cur + S.neg_step_cost_slack)[:, None]
    # The th_grad escape hatch means "expected gradient negligible,
    # accept to avoid stalling"; it requires the gradient to actually be
    # small and bounds the cost.
    ok_pos = (dVexp >= 0) & (
        ((d1.abs() < S.th_grad) & (cost_try < cost_guard))
        | (dV > S.th_acceptstep * dVexp))
    # Negative-improvement (gap-contraction) acceptance, with a
    # robustness clamp: each accepted cost increase is bounded
    # multiplicatively.
    ok_neg = ((dVexp < 0) & (dV > S.th_acceptnegstep * dVexp)
              & (cost_try < cost_guard))
    ok = finite & (ok_pos | ok_neg)                         # (B, A)

    # Selection by gather, never by a one-hot product: rejected step
    # lengths can carry inf/NaN, and 0 * nan would poison the pick.
    accepted = ok.any(dim=1)
    sel = torch.argmax(ok.to(torch.int8), dim=1)  # first True == largest alpha
    rows = torch.arange(B, device=xs.device)
    return LineSearchStep(
        accepted=accepted, alpha=alphas[sel],
        xs=_select(accepted, xs_try[rows, sel], xs),
        us=_select(accepted, us_try[rows, sel], us),
        cost=torch.where(accepted, cost_try[rows, sel], cost_cur))


class BackwardInputs(NamedTuple):
    """What one iteration hands the backward sweep (all but the regs), plus
    the quantities the line search needs from the same derivative pass."""
    args: tuple              # (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_scaled, LxT, LxxT, lb, ub)
    fs: torch.Tensor         # (B, N+1, nx) unscaled gaps
    cost_cur: torch.Tensor   # (B,)
    feasible: torch.Tensor   # (B,) bool


def control_bounds(knot: KnotModel, dtype, device):
    """The knot's torque bounds (u_lb, u_ub) as (nu,) tensors."""
    return (torch.tensor(knot.u_lb, dtype=dtype, device=device),
            torch.tensor(knot.u_ub, dtype=dtype, device=device))


def backward_inputs(d: KnotDerivs, x0, xs, us, feasible, u_lb, u_ub) -> BackwardInputs:
    """What one iteration builds from its derivative pass ``d``
    (``diff_all`` / ``diff_reference`` of ``xs``, ``us``): the current cost,
    gaps, sticky feasibility, and the backward sweep's inputs with the gap
    rows scaled by the infeasibility weight and bounds relative to ``us``."""
    derivs = d.run
    cost_cur = torch.sum(derivs.cost, dim=1) + d.cost_T
    fs = _compute_gaps(x0, xs, derivs.xnext)
    gap_norm = fs.abs().amax(dim=(1, 2))
    feasible = feasible | (gap_norm < 1e-9)
    gapw = torch.where(feasible, 0.0, 1.0).to(xs.dtype)
    args = (derivs.Fx, derivs.Fu, derivs.Lx, derivs.Lu, derivs.Lxx, derivs.Lxu,
            derivs.Luu, gapw[:, None, None] * fs, d.LxT, d.LxxT, u_lb - us, u_ub - us)
    return BackwardInputs(tuple(a.contiguous() for a in args), fs, cost_cur,
                          feasible)


def solve(knot: KnotModel, refs_run: ProblemRefs, ref_T: ProblemRefs, x0,
          xs_init, us_init, settings: FDDPSettings = FDDPSettings(),
          reg0: Optional[torch.Tensor] = None,
          consts: Optional[torch.Tensor] = None) -> FDDPResult:
    """Solve B shooting problems at once.

    refs_run: leading dims (B, N); ref_T: leading dim (B,); x0 (B, nx);
    xs_init (B, N+1, nx); us_init (B, N, nu); ``reg0`` optional (B,)
    overrides settings.reg_init per problem (an MPC loop carries the previous
    solve's final regularization here).  ``consts`` optional: the knot's
    ``pack_knot_consts`` in the solve's dtype, for callers that solve the
    same knot many times (packed here otherwise; ``family=knot.family``).  Runs on the device and in
    the dtype of ``xs_init``."""
    S = settings
    if S.backward_mode not in ("kernel", "plain"):
        raise ValueError(f"unknown backward_mode {S.backward_mode!r}")
    if S.rollout_mode not in ("kernel", "plain"):
        raise ValueError(f"unknown rollout_mode {S.rollout_mode!r}")
    if S.diff_mode not in ("kernel", "plain"):
        raise ValueError(f"unknown diff_mode {S.diff_mode!r}")
    if consts is not None and consts.numel() != consts_len(family_of(knot), contact_of(knot)):
        # checked on every device: another family's or contact model's layout
        # never reaches a kernel
        raise ValueError(f"solve: consts hold {consts.numel()} values, the {knot.family} "
                         f"knot's pack_knot_consts of the {knot.W.contact_model} contact "
                         f"{consts_len(knot.family, knot.W.contact_model)}")
    nx, nu = knot.nx, knot.nu
    B, N = us_init.shape[0], us_init.shape[1]
    dtype, device = xs_init.dtype, xs_init.device
    kw = dict(dtype=dtype, device=device)

    bw_fn = backward_box if S.backward_mode == "kernel" else backward_box_reference
    # the kernels read their inputs as contiguous arrays
    x0, xs_init, us_init = x0.contiguous(), xs_init.contiguous(), us_init.contiguous()
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    if "kernel" in (S.rollout_mode, S.diff_mode) and consts is None:
        consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family)
    # the rollout kernel reads its constants from device memory: one copy a
    # solve (the derivative kernel takes the host tensor)
    rollout_consts = consts.to(device) if S.rollout_mode == "kernel" else None
    u_lb, u_ub = control_bounds(knot, dtype, device)

    # ---------------- derivative pass: running and terminal knots ---------
    def derivatives(xs, us):
        if S.diff_mode == "kernel":
            return diff_all(knot, consts, refs_run, ref_T, xs, us)
        return diff_reference(knot, refs_run, ref_T, xs, us)

    # ---------------- forward pass: all step lengths in one rollout -------
    def forward(xs, us, K, kff, fs, w_all, feasible):
        if S.rollout_mode == "kernel":
            return rollout(knot, rollout_consts, x0, xs, us, K, kff, fs, w_all, feasible,
                           refs_run, ref_T, S.n_alphas)
        return rollout_reference(knot, x0, xs, us, K, kff, fs, w_all, feasible,
                                 refs_run, ref_T, S.n_alphas)

    # ---------------- one FDDP iteration (all problems) -------------------
    def iteration(c: _Carry) -> _Carry:
        bi = backward_inputs(derivatives(c.xs, c.us), x0, c.xs, c.us, c.feasible,
                             u_lb, u_ub)
        fs, cost_cur, feasible = bi.fs, bi.cost_cur, bi.feasible

        def bw(xreg, ureg):
            return bw_fn(*bi.args, xreg.contiguous(), ureg.contiguous(),
                         boxqp_iters=S.boxqp_iters, kgain_reg=KGAIN_REG)

        # backward pass with per-problem regularization retry on an
        # indefinite Quu: only problems whose sweep went non-finite (and can
        # still raise their regularization) take the new outputs and regs
        xreg, ureg = c.xreg, c.ureg
        out = bw(xreg, ureg)
        while True:
            pred = out[5] & (xreg < S.reg_max)
            if not bool(pred.any()):
                break
            xr_n = torch.clamp(xreg * S.reg_inc, max=S.reg_max)
            out_n = bw(xr_n, xr_n)
            out = tuple(_select(pred, n, o) for n, o in zip(out_n, out))
            xreg = torch.where(pred, xr_n, xreg)
            ureg = torch.where(pred, xr_n, ureg)
        K, kff, stop, dg, dq, bw_bad, w_all = out

        # Line search: ALL step lengths roll out in one batched pass, then
        # the largest acceptable alpha is selected per problem.  Equivalent
        # to Crocoddyl's first-acceptable descending sweep with fixed cost.
        xs_try, us_try, cost_try, dv = forward(c.xs, c.us, K, kff, fs, w_all, feasible)
        ls = accept_step(S, c.xs, c.us, cost_cur, xs_try, us_try, cost_try, dv, dg, dq)
        accepted, alpha_f = ls.accepted, ls.alpha
        xs_new, us_new, cost_new = ls.xs, ls.us, ls.cost
        feasible_new = feasible | (accepted & (alpha_f >= 1.0 - 1e-12))

        # regularization schedule (crocoddyl solve loop)
        dec = accepted & (alpha_f > S.th_stepdec)
        inc = (~accepted) | (alpha_f <= S.th_stepinc)
        xreg_new = torch.where(dec, torch.clamp(xreg / S.reg_dec, min=S.reg_min), xreg)
        xreg_new = torch.where(inc, torch.clamp(xreg_new * S.reg_inc, max=S.reg_max),
                               xreg_new)
        diverged = (inc & (xreg >= S.reg_max)) | (bw_bad & (xreg >= S.reg_max))
        converged = feasible_new & (stop < S.th_stop)

        step = torch.where(accepted, alpha_f, torch.zeros_like(alpha_f))
        col = c.it.long().clamp(max=S.max_iters - 1)[:, None]   # live: it < max_iters
        alpha_hist_new = c.alpha_hist.scatter(1, col, step[:, None])

        return _Carry(xs=xs_new, us=us_new, cost=cost_new, feasible=feasible_new,
                      xreg=xreg_new, ureg=xreg_new, it=c.it + 1,
                      converged=converged, diverged=diverged, K=K, kff=kff,
                      stop=stop, alpha_hist=alpha_hist_new)

    def live(c: _Carry):
        return (c.it < S.max_iters) & (~c.converged) & (~c.diverged)

    if reg0 is None:
        reg_start = torch.full((B,), S.reg_init, **kw)
    else:
        reg_start = torch.clamp(torch.as_tensor(reg0, **kw).expand(B),
                                S.reg_min, 1e4)
    c = _Carry(
        xs=xs_init, us=us_init,
        cost=torch.full((B,), float("inf"), **kw),
        feasible=torch.zeros(B, dtype=torch.bool, device=device),
        xreg=reg_start, ureg=reg_start,
        it=torch.zeros(B, dtype=torch.int32, device=device),
        converged=torch.zeros(B, dtype=torch.bool, device=device),
        diverged=torch.zeros(B, dtype=torch.bool, device=device),
        K=torch.zeros(B, N, nu, nx, **kw), kff=torch.zeros(B, N, nu, **kw),
        stop=torch.full((B,), float("inf"), **kw),
        alpha_hist=torch.zeros(B, max(S.max_iters, 0), **kw),
    )
    while True:
        pred = live(c)
        if not bool(pred.any()):
            break
        c_new = iteration(c)
        # finished problems freeze their whole carry
        c = _Carry(*(_select(pred, n, o) for n, o in zip(c_new, c)))

    # final cost of the returned trajectory (carry cost is inf if 0 iterations)
    _, costs = knot.calc(refs_run, c.xs[:, :-1], c.us)
    cost_final = torch.sum(costs, dim=1) + knot.term_calc(ref_T, c.xs[:, -1])

    return FDDPResult(
        xs=c.xs, us=c.us, K=c.K, k=c.kff,
        cost=cost_final, stop=c.stop, iters=c.it,
        converged=c.converged, diverged=c.diverged,
        feasible=c.feasible, xreg=c.xreg, alpha_hist=c.alpha_hist,
    )
