"""Projected-Newton box-QP used by BoxFDDP's backward pass.

PyTorch counterpart of ``ffmpc_tpu/solver/boxqp.py``, batched.  Solves

    min_x  0.5 x^T Q x + q^T x   s.t.  lb <= x <= ub

with an active-set projected-Newton iteration.  Fixed iteration count and
masked linear solves: one dense (n, n) solve serves any active set, so the
whole batch moves in lockstep whatever each problem's active set is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.smallchol import spd_solve, matvec as _mv


class BoxQPResult(NamedTuple):
    x: torch.Tensor       # (..., n) solution
    free: torch.Tensor    # (..., n) bool free-dimension mask at the solution


def _masked_solve(Q, rhs, free, reg):
    """Solve Q_ff y_f = rhs_f on the free subspace; clamped dims get 0.

    Masking trick: clamped rows/cols are replaced by identity.
    Q: (..., n, n); free: (..., n) bool; rhs: (..., n) or (..., n, m).
    """
    n = Q.shape[-1]
    fm = free.to(Q.dtype)
    mask2 = fm[..., :, None] * fm[..., None, :]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    Qm = Q * mask2 + torch.diag_embed(1.0 - fm) + reg * eye
    # Qm is SPD (PSD Q on the free block, identity on the clamped block)
    if rhs.dim() == Q.dim() - 1:
        return spd_solve(Qm, rhs * fm)
    return spd_solve(Qm, rhs * fm[..., :, None])


def _free_set(Q, q, lb, ub, x, eps):
    g = q + _mv(Q, x)
    lo = (x <= lb + eps) & (g > 0)
    hi = (x >= ub - eps) & (g < 0)
    return g, ~(lo | hi)


def boxqp(Q, q, lb, ub, x0, *, iters: int = 8, reg: float = 1e-9) -> BoxQPResult:
    """Fixed-iteration projected Newton with a 4-point step-size polish.

    ``torch.maximum`` / ``minimum`` propagate NaN and ``argmin`` picks the
    first NaN (else the first minimum), so an indefinite Q surfaces as a
    non-finite x."""
    eps = 1e-9

    def obj(xx):
        return 0.5 * torch.sum(xx * _mv(Q, xx), dim=-1) + torch.sum(q * xx, dim=-1)

    def clip(xx):
        return torch.minimum(torch.maximum(xx, lb), ub)

    x = clip(x0)
    for _ in range(iters):
        g, free = _free_set(Q, q, lb, ub, x, eps)
        dx = -_masked_solve(Q, g, free, reg)
        # monotone step polish: pick the best of a few scaled candidates
        cands = torch.stack([x, clip(x + dx), clip(x + 0.5 * dx),
                             clip(x + 0.25 * dx)])
        vals = torch.stack([obj(c) for c in cands])              # (4, ...)
        best = torch.argmin(vals, dim=0)                         # (...,)
        x = torch.gather(cands, 0, best[None, ..., None].expand(
            (1,) + x.shape))[0]

    _, free = _free_set(Q, q, lb, ub, x, eps)
    return BoxQPResult(x=x, free=free)
