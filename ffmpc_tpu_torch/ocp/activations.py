"""Activation models: value / gradient / diagonal-Hessian on residuals.

PyTorch counterpart of ``ffmpc_tpu/ocp/activations.py``.  Each activation is
a static spec tuple; Gauss-Newton cost assembly uses ``grad`` and
``hess_diag`` (second derivatives of the residuals are dropped).  Residuals
carry leading batch dims; ``value`` reduces the last axis only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Activation(NamedTuple):
    kind: str                                  # "quad" | "wquad" | "barrier"
    weights: Optional[Tuple[float, ...]] = None  # wquad diagonal
    lb: Optional[Tuple[float, ...]] = None       # barrier bounds
    ub: Optional[Tuple[float, ...]] = None


def quad() -> Activation:
    return Activation("quad")


def wquad(weights) -> Activation:
    return Activation("wquad", weights=tuple(float(w) for w in np.asarray(weights).ravel()))


def barrier(lb, ub) -> Activation:
    return Activation(
        "barrier",
        lb=tuple(float(v) for v in np.asarray(lb).ravel()),
        ub=tuple(float(v) for v in np.asarray(ub).ravel()),
    )


def _const(values, r):
    return torch.tensor(values, dtype=r.dtype, device=r.device)


def _over(act: Activation, r):
    lb = _const(act.lb, r)
    ub = _const(act.ub, r)
    return torch.clamp(r - ub, min=0.0) + torch.clamp(r - lb, max=0.0)


def value(act: Activation, r):
    if act.kind == "quad":
        return 0.5 * torch.sum(r * r, dim=-1)
    if act.kind == "wquad":
        return 0.5 * torch.sum(_const(act.weights, r) * r * r, dim=-1)
    o = _over(act, r)
    return 0.5 * torch.sum(o * o, dim=-1)


def grad(act: Activation, r):
    if act.kind == "quad":
        return r
    if act.kind == "wquad":
        return _const(act.weights, r) * r
    return _over(act, r)


def hess_diag(act: Activation, r):
    if act.kind == "quad":
        return torch.ones_like(r)
    if act.kind == "wquad":
        return _const(act.weights, r).expand(r.shape)
    return (torch.abs(_over(act, r)) > 0.0).to(r.dtype)
