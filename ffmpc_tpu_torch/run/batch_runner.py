"""Batched warm-started BoxFDDP solves of the full-horizon problem.

PyTorch counterpart of ``ffmpc_tpu/run/batch_runner.py``; ported so far:
``EpisodeConfig`` and ``make_batched_solve_fn`` for the force-feedback
controller.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..core.panda import PandaModel
from ..core.dynamics import gravity_torque
from ..ocp.action import make_augmented_knot
from ..ocp.problem import build_problem_refs
from ..ocp.weights import OCPWeights
from ..solver.fddp import solve as fddp_solve, FDDPSettings
from ..mpc.controllers import make_vertical_down_R


@dataclass(frozen=True)
class EpisodeConfig:
    """The fields ``make_batched_solve_fn`` reads; the closed-loop episode's
    settings join when the episode is ported."""
    controller: str = "force_feedback"   # the only knot family ported
    horizon: int = 36


def make_batched_solve_fn(model: PandaModel, W: OCPWeights,
                          settings: FDDPSettings, traj, ep: EpisodeConfig,
                          q_nom, surface: bool = True, dtype=torch.float32,
                          device="cuda"):
    """B independent warm-started BoxFDDP solves of the full-horizon problem.

    Returns ``batched(ts (B,), x0s (B, nx), xs_w (B, N+1, nx),
    us_w (B, N, nu)) -> FDDPResult`` with batch-leading fields.  Inputs may
    be numpy arrays or tensors; they are moved to ``device`` / ``dtype``
    (``model`` must already live there)."""
    dev = resolve_device(device)
    if ep.controller != "force_feedback":
        raise ValueError(
            f"controller {ep.controller!r}: only the force_feedback "
            "(augmented) knot family is ported")
    mdev = model.mass.device
    same_device = mdev.type == dev.type and (dev.index is None or mdev.index == dev.index)
    if not same_device or model.mass.dtype != dtype:
        raise ValueError(
            f"model lives on {model.mass.device}/{model.mass.dtype}, "
            f"solve was asked for {dev}/{dtype}")
    N = ep.horizon
    knot = make_augmented_knot(model, W, surface=surface)
    R_des = torch.as_tensor(make_vertical_down_R(), dtype=dtype, device=dev)
    q_nom = torch.as_tensor(np.asarray(q_nom), dtype=dtype, device=dev)
    x_reg_nom = torch.cat([q_nom, torch.zeros(7, dtype=dtype, device=dev)])

    def batched(ts, x0s, xs_w, us_w):
        ts, x0s, xs_w, us_w = (torch.as_tensor(a, dtype=dtype, device=dev)
                               for a in (ts, x0s, xs_w, us_w))
        tau_refs = gravity_torque(model, x0s[:, :7])
        refs_run, ref_T = build_problem_refs(
            traj, ts, N, W.dt_ocp, x_reg_nom, tau_refs, R_des, y_ref=x0s,
            dtype=dtype, device=dev)
        return fddp_solve(knot, refs_run, ref_T, x0s, xs_w, us_w, settings)

    return batched
