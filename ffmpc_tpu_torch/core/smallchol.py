"""Unrolled Cholesky factorization/solve for small SPD systems.

PyTorch counterpart of ``ffmpc_tpu/core/smallchol.py``.  The matrices are
tiny (7x7 joint-space systems, nc<=3 contact Schur complements) and the batch
is large, so the factorization is unrolled over the n columns, each step a
handful of batched vector ops.  An indefinite input yields NaN (``sqrt`` of a
negative pivot) instead of raising: the solver's regularization retry keys on
that.

All functions broadcast over arbitrary leading batch dims; n is static.
"""

from __future__ import annotations

import torch


def matvec(A, x):
    """Batched matrix-vector product: (..., i, j) x (..., j) -> (..., i)."""
    return (A @ x[..., None])[..., 0]


def chol_factor(A):
    """Lower-triangular Cholesky of SPD A (..., n, n), unrolled over columns.

    Returns L with A = L L^T.
    """
    n = A.shape[-1]
    cols = []   # cols[j]: (..., n) column j of L, zeros above the diagonal
    for j in range(n):
        s = A[..., :, j]
        for k in range(j):
            s = s - cols[k] * cols[k][..., j:j + 1]
        d = torch.sqrt(s[..., j:j + 1])
        col = s / d
        if j:
            col = torch.cat([torch.zeros_like(col[..., :j]), col[..., j:]], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def chol_solve(L, b):
    """Solve A x = b given L = chol_factor(A).

    b: (..., n) or (..., n, m); returns the matching shape.
    """
    n = L.shape[-1]
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    # backward: L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def spd_solve(A, b):
    """x = A^{-1} b for small SPD A via the unrolled factorization."""
    return chol_solve(chol_factor(A), b)
