"""Closed-loop MPC episodes and batched warm-started BoxFDDP solves.

PyTorch counterpart of ``ffmpc_tpu/run/batch_runner.py``, for both
controllers: the force-feedback controller's augmented knot (nx = 21) and
the classical controller's knot (x = (q, v), nx = 14).
``make_episode_fn`` is the receding-horizon loop (problem construction,
warm-started BoxFDDP solve on the three kernels, the policy: for force
feedback the Eq. 14 interpolated torque with the inverse actuation map, for
the classical controller the first control; the divergence guard and torque
clamp, and the 1 kHz plant substeps, for a batch of E episodes at once);
``make_batched_solve_fn`` runs B independent solves of the full-horizon
problem.

Where the JAX package scans ticks and vmaps episodes, this module loops over
ticks in Python and carries the episode batch as a leading dimension.  Every
episode of a batch shares the tick's time, so the contact / free knot family
is chosen on the host from the trajectory's surface flag, evaluated on a CPU
tensor of the episode's dtype (the times are built as the JAX episode builds
them, so the switch falls on the same tick); nothing is read back from the
card to decide it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.panda import PandaModel
from ..core.dynamics import gravity_torque
from ..ocp.action import make_augmented_knot, make_classical_knot
from ..ocp.problem import build_problem_refs
from ..ocp.weights import OCPWeights
from ..solver.fddp import solve as fddp_solve, FDDPSettings
from ..solver.rollout_cuda import pack_knot_consts
from ..sim.device_plant import TableParams, plant_step, init_plant_state
from ..mpc.controllers import make_vertical_down_R


@dataclass(frozen=True)
class EpisodeConfig:
    # "force_feedback" (the augmented knot) or "classical" (x = (q, v))
    controller: str = "force_feedback"
    horizon: int = 36
    dt_mpc: float = 0.005
    plant_timestep: float = 0.001
    n_substeps: int = 5
    n_ticks: int = 400
    # the OCP's filter pole is W.ff_alpha; the JAX config's ff_alpha_ocp and
    # feedback_gain_scale are read by no episode and are not carried over
    ff_alpha_ctrl: float = 0.0           # exp(-2 pi fc dt_mpc)
    ff_inverse_actuation: bool = True
    posture_ref_q_nom: bool = True


@dataclass(frozen=True)
class DeviceUncertainty:
    """The benchmark's uncertainty protocol on the device: actuation gain a
    and bias b on the command and (force feedback) on the torque estimate,
    and Gaussian sensor noise on q, v and the torque estimate.  At the
    200 Hz control loop the reference's 2 ms observation and 1 ms command
    delays round to zero control steps, so no delay is applied."""
    a: float = 1.0          # actuation gain
    b: float = 0.0          # actuation bias [Nm]
    sigma_q: float = 0.0
    sigma_dq: float = 0.0
    sigma_tau: float = 0.0
    seed: int = 0


_KNOT_OF = {"force_feedback": make_augmented_knot, "classical": make_classical_knot}


def _check_controller(ep: EpisodeConfig):
    if ep.controller not in _KNOT_OF:
        raise ValueError(f"controller {ep.controller!r}: expected one of {sorted(_KNOT_OF)}")


def _check_model(model: PandaModel, dev: torch.device, dtype):
    mdev = model.mass.device
    same_device = mdev.type == dev.type and (dev.index is None or mdev.index == dev.index)
    if not same_device or model.mass.dtype != dtype:
        raise ValueError(
            f"model lives on {model.mass.device}/{model.mass.dtype}, "
            f"the caller asked for {dev}/{dtype}")


def tick_noise(unc: DeviceUncertainty, tick: int, dtype, device) -> torch.Tensor:
    """The tick's four standard-normal (7,) draws (q, v, torque estimate,
    command), shared by every episode of a batch as the JAX episode shares
    its key.  Drawn from a ``torch.Generator`` seeded by (seed, tick index),
    not by stream position, so a chunked episode draws what a whole one
    does.  The numbers differ from ``jax.random``'s by design: the two
    generators are different functions of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(unc.seed) * 1_000_003 + int(tick)) % (2 ** 63))
    return torch.randn((4, 7), generator=g, dtype=dtype, device=device)


def make_episode_fn(model: PandaModel, W: OCPWeights, settings: FDDPSettings,
                    traj, table: TableParams, ep: EpisodeConfig, q_nom,
                    torque_scale=None, uncertainty: Optional[DeviceUncertainty] = None,
                    dtype=torch.float32, device="cuda"):
    """Build a closed-loop episode function over a batch of E episodes of
    ``ep.controller`` (its knot: nx = 21 for "force_feedback", 14 for
    "classical").

    ``episode(q0s (E, 7), table_v=None)`` runs ``ep.n_ticks`` ticks from
    t = 0 and returns a dict of (E, n_ticks, ...) telemetry tensors (the JAX
    episode's keys: t, err_tan, err_3d, fn_meas, cost, iters, tau_cmd,
    ee_pos, q; and ``fallback``, True on a tick that took the divergence
    fallback).  ``episode.init(q0s)`` returns the carry
    (PlantState, xs, us, tau_prev, reg); ``episode.chunk(carry, t0, n_ticks,
    table_v=None)`` advances it and returns (carry, telem).  ``table_v``
    overrides ``table`` for the call.  ``model`` and ``table`` must live on
    ``device`` in ``dtype``."""
    dev = resolve_device(device)
    _check_controller(ep)
    _check_model(model, dev, dtype)
    N = ep.horizon
    is_ff = ep.controller == "force_feedback"
    kw = dict(dtype=dtype, device=dev)
    knots = {s: _KNOT_OF[ep.controller](model, W, surface=s) for s in (True, False)}
    # each knot's kernel constants, packed once: the derivative kernel
    # copies them to __constant__ memory at every launch and fddp.solve
    # copies them to the card once a solve for the rollout kernel, so
    # switching knots between ticks never reuses the other knot's
    uses_kernel = "kernel" in (settings.rollout_mode, settings.diff_mode)
    consts = {s: (pack_knot_consts(model, W, s, dtype, family=knots[s].family)
                  if uses_kernel else None)
              for s in (True, False)}
    R_des = torch.as_tensor(make_vertical_down_R(), **kw)
    q_nom = torch.as_tensor(np.asarray(q_nom), **kw)
    x_reg_nom = torch.cat([q_nom, torch.zeros(7, **kw)])
    tau_limit = model.tau_limit.to(**kw)
    tscale = None if torque_scale is None else torch.as_tensor(np.asarray(torque_scale), **kw)
    eps_pol = float(np.clip(ep.dt_mpc / W.dt_ocp, 0.0, 1.0))
    beta_c = max(1e-6, 1.0 - ep.ff_alpha_ctrl)
    unc = uncertainty

    def tick(carry, t_host: torch.Tensor, t_dev: torch.Tensor, tbl: TableParams):
        plant, xs_w, us_w, _, reg = carry
        E = plant.q.shape[0]
        q, v = plant.q, plant.v
        if unc is not None:
            nz = tick_noise(unc, int((t_host / ep.dt_mpc).to(torch.int32)), dtype, dev)
            q = q + unc.sigma_q * nz[0]
            v = v + unc.sigma_dq * nz[1]
        if is_ff:
            tau_hat = plant.tau_meas_act_filt
            if unc is not None:
                tau_hat = unc.a * tau_hat + unc.b + unc.sigma_tau * nz[2]
            x0 = torch.cat([q, v, tau_hat], dim=-1)
        else:
            x0 = torch.cat([q, v], dim=-1)

        # warm start: shift the previous solution one knot, pin x0 in place
        # of the shifted first state (as the JAX episode does)
        xs_init = torch.cat([x0[:, None], xs_w[:, 2:], xs_w[:, -1:]], dim=1)
        us_init = torch.cat([us_w[:, 1:], us_w[:, -1:]], dim=1)

        tau_ref = gravity_torque(model, q)
        surf = bool(traj(t_host)[2])
        refs_run, ref_T = build_problem_refs(
            traj, t_dev.expand(E), N, W.dt_ocp,
            x_reg_nom if ep.posture_ref_q_nom else x0[:, :14], tau_ref, R_des,
            y_ref=(x0 if is_ff else None), dtype=dtype, device=dev)
        res = fddp_solve(knots[surf], refs_run, ref_T, x0, xs_init, us_init, settings,
                         reg0=reg, consts=consts[surf])
        # regularization carried across ticks (avoids re-climbing the ladder
        # on the stiff contact problem every solve)
        reg_next = torch.clamp(res.xreg, settings.reg_min, 1e4)

        if is_ff:
            tau0 = res.xs[:, 0, 14:21]
            tau1 = res.xs[:, 1, 14:21]
            tau_tilde = tau0 + eps_pol * (tau1 - tau0)          # Eq. 14
            # at the solve point the feedback terms vanish (x0 == xs[0]);
            # keep the torque interpolation and the inverse actuation map
            if ep.ff_inverse_actuation:
                tau_raw = (tau_tilde - ep.ff_alpha_ctrl * tau_hat) / beta_c
            else:
                tau_raw = tau_tilde
        else:
            tau_raw = res.us[:, 0]

        # divergence guard + hard clamp (the reference's compute_control tail)
        unstable = ((~torch.isfinite(res.cost)) | (res.cost > 1e8)
                    | (tau_raw.abs().amax(dim=-1) > 3e2))
        tau_fallback = gravity_torque(model, q) - 5.0 * v
        tau_cmd = torch.where(unstable[:, None], tau_fallback, tau_raw)
        tau_cmd = torch.clamp(tau_cmd, -tau_limit, tau_limit)

        tau_applied = tau_cmd if tscale is None else tau_cmd * tscale
        if unc is not None:
            # actuation gain / bias + noise on the plant-side command
            tau_applied = unc.a * tau_cmd + unc.b + unc.sigma_tau * nz[3]
        plant_new, obs = plant_step(model, tbl, plant, tau_applied,
                                    timestep=ep.plant_timestep, n_substeps=ep.n_substeps)

        t_next = t_dev + ep.dt_mpc
        p_ref, _, _ = traj(t_next)
        err = obs.ee_pos - p_ref
        telem = {
            "t": t_next.expand(E),
            "err_tan": torch.linalg.vector_norm(err[:, :2], dim=-1),
            "err_3d": torch.linalg.vector_norm(err, dim=-1),
            "fn_meas": obs.f_contact_normal,
            "cost": res.cost,
            "iters": res.iters,
            "tau_cmd": tau_cmd,
            "ee_pos": obs.ee_pos,
            "q": obs.q,
            "fallback": unstable,
        }
        return (plant_new, res.xs, res.us, tau_cmd, reg_next), telem

    def episode_init(q0s):
        q0s = torch.as_tensor(q0s, **kw)
        if q0s.dim() != 2 or q0s.shape[1] != 7:
            raise ValueError(f"q0s must be (E, 7); got {tuple(q0s.shape)}")
        E = q0s.shape[0]
        plant0 = init_plant_state(q0s, dtype=dtype, device=dev)
        tau_g = gravity_torque(model, q0s)
        x0 = torch.cat([q0s, torch.zeros_like(q0s)] + ([tau_g] if is_ff else []), dim=-1)
        xs0 = x0[:, None].repeat(1, N + 1, 1)
        us0 = tau_g[:, None].repeat(1, N, 1)
        reg0 = torch.full((E,), settings.reg_init, **kw)
        return (plant0, xs0, us0, tau_g, reg0)

    def episode_chunk(carry, t0, n_ticks: int, table_v: Optional[TableParams] = None):
        """Advance ``n_ticks`` ticks from time ``t0``: (carry, telem)."""
        tbl = table if table_v is None else table_v
        # tick times in the episode's dtype, formed as the JAX episode forms
        # them (t0 + k * dt_mpc), on the host for the knot switch
        ts = (torch.as_tensor(t0, dtype=dtype).cpu()
              + torch.arange(n_ticks, dtype=dtype) * ep.dt_mpc)
        ts_dev = ts.to(dev)
        rows = []
        for k in range(n_ticks):
            carry, telem = tick(carry, ts[k], ts_dev[k], tbl)
            rows.append(telem)
        telem = {key: torch.stack([r[key] for r in rows], dim=1) for key in rows[0]} \
            if rows else {}
        return carry, telem

    def episode(q0s, table_v: Optional[TableParams] = None):
        _, telem = episode_chunk(episode_init(q0s), 0.0, ep.n_ticks, table_v=table_v)
        return telem

    episode.init = episode_init
    episode.chunk = episode_chunk
    return episode


def make_batched_solve_fn(model: PandaModel, W: OCPWeights,
                          settings: FDDPSettings, traj, ep: EpisodeConfig,
                          q_nom, surface: bool = True, dtype=torch.float32,
                          device="cuda"):
    """B independent warm-started BoxFDDP solves of the full-horizon problem.

    Returns ``batched(ts (B,), x0s (B, nx), xs_w (B, N+1, nx),
    us_w (B, N, nu)) -> FDDPResult`` with batch-leading fields: nx = 21
    for ``ep.controller == "force_feedback"`` (the augmented knot, its state
    reference the problem's first state), nx = 14 for "classical".  Inputs
    may be numpy arrays or tensors; they are moved to ``device`` / ``dtype``
    (``model`` must already live there)."""
    dev = resolve_device(device)
    _check_controller(ep)
    _check_model(model, dev, dtype)
    N = ep.horizon
    is_ff = ep.controller == "force_feedback"
    knot = _KNOT_OF[ep.controller](model, W, surface=surface)
    R_des = torch.as_tensor(make_vertical_down_R(), dtype=dtype, device=dev)
    q_nom = torch.as_tensor(np.asarray(q_nom), dtype=dtype, device=dev)
    x_reg_nom = torch.cat([q_nom, torch.zeros(7, dtype=dtype, device=dev)])

    def batched(ts, x0s, xs_w, us_w):
        ts, x0s, xs_w, us_w = (torch.as_tensor(a, dtype=dtype, device=dev)
                               for a in (ts, x0s, xs_w, us_w))
        tau_refs = gravity_torque(model, x0s[:, :7])
        refs_run, ref_T = build_problem_refs(
            traj, ts, N, W.dt_ocp, x_reg_nom, tau_refs, R_des,
            y_ref=(x0s if is_ff else None), dtype=dtype, device=dev)
        return fddp_solve(knot, refs_run, ref_T, x0s, xs_w, us_w, settings)

    return batched
