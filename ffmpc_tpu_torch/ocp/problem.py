"""Shooting-problem construction: per-knot reference tensors from a trajectory.

PyTorch counterpart of ``ffmpc_tpu/ocp/problem.py``, batched over
(t0, tau_ref, x0): sample the task trajectory at t0 + k*dt_ocp for
k = 0..N, bundle regularization references, and emit the
(refs_run, ref_T) pair the solver consumes.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .._device import resolve_device
from .weights import ProblemRefs


def build_problem_refs(
    traj_fn: Callable,
    t0,
    N: int,
    dt_ocp: float,
    x_reg_ref,
    tau_ref,
    R_des,
    y_ref=None,
    dtype=torch.float32,
    device="cuda",
) -> Tuple[ProblemRefs, ProblemRefs]:
    """t0: (B,).  x_reg_ref (14,), tau_ref (7,), R_des (3, 3), y_ref (21,)
    may each carry a leading B or be shared by the batch.
    Returns (refs_run with leading dims (B, N), ref_T with leading dim (B,))."""
    dev = resolve_device(device)
    t0 = torch.as_tensor(t0, dtype=dtype, device=dev)
    if t0.dim() != 1:
        raise ValueError(f"t0 must be a (B,) tensor, got shape {tuple(t0.shape)}")
    B = t0.shape[0]
    ts = t0[:, None] + (torch.arange(N + 1, dtype=dtype, device=dev)
                        * torch.as_tensor(dt_ocp, dtype=dtype, device=dev))
    p_ref, v_ref, _ = traj_fn(ts)                        # (B, N+1, 3)

    if y_ref is None:
        y_ref = torch.zeros(21, dtype=dtype, device=dev)

    def bc(a, shape):
        a = torch.as_tensor(a, dtype=dtype, device=dev)
        if a.dim() == len(shape) + 1:                    # per-problem (B, ...)
            a = a[:, None]
        return a.expand((B, N + 1) + shape)

    refs_all = ProblemRefs(
        p_ref=p_ref.to(dtype),
        v_ref=v_ref.to(dtype),
        x_reg_ref=bc(x_reg_ref, (14,)),
        tau_ref=bc(tau_ref, (7,)),
        R_des=bc(R_des, (3, 3)),
        y_ref=bc(y_ref, (21,)),
    )
    refs_run = ProblemRefs(*(a[:, :N] for a in refs_all))
    ref_T = ProblemRefs(*(a[:, N] for a in refs_all))
    return refs_run, ref_T
