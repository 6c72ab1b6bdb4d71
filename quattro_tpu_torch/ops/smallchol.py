"""Batched Cholesky factorize-and-solve for tiny SPD systems (pure forms).

Counterpart of the pure-jnp half of ``quattro_tpu/ops/smallchol.py``: the
Cholesky-Crout factorization and both triangular solves unrolled over the
small matrix dimension m, batched over leading dimensions. The batched
kernel of that module (``batched_cholesky_solve_pallas``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _unrolled_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with A = L L^T for (..., m, m) SPD matrices."""
    m = a.shape[-1]
    cols = [[None] * m for _ in range(m)]  # cols[i][j] = L[i, j], j <= i
    for j in range(m):
        diag = a[..., j, j]
        for k in range(j):
            diag = diag - cols[j][k] * cols[j][k]
        ljj = torch.sqrt(diag)
        cols[j][j] = ljj
        inv_ljj = 1.0 / ljj
        for i in range(j + 1, m):
            off = a[..., i, j]
            for k in range(j):
                off = off - cols[i][k] * cols[j][k]
            cols[i][j] = off * inv_ljj
    zero = torch.zeros_like(cols[0][0])
    rows = [torch.stack([cols[i][j] if j <= i else zero for j in range(m)], dim=-1) for i in range(m)]
    return torch.stack(rows, dim=-2)


def _forward_substitute(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b for lower-triangular L; b is (..., m, r)."""
    m = l.shape[-1]
    ys = []
    for i in range(m):
        acc = b[..., i, :]
        for k in range(i):
            acc = acc - l[..., i, k, None] * ys[k]
        ys.append(acc / l[..., i, i, None])
    return torch.stack(ys, dim=-2)


def _back_substitute(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y for lower-triangular L; y is (..., m, r)."""
    m = l.shape[-1]
    xs: list = [None] * m
    for i in reversed(range(m)):
        acc = y[..., i, :]
        for k in range(i + 1, m):
            acc = acc - l[..., k, i, None] * xs[k]
        xs[i] = acc / l[..., i, i, None]
    return torch.stack(xs, dim=-2)


def batched_cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A X = B for batches of small SPD A; returns (x, L)."""
    l = _unrolled_cholesky(a)
    return _back_substitute(l, _forward_substitute(l, b)), l


def batched_spd_solve(a: torch.Tensor, b: torch.Tensor, small_dim_max: int = 8) -> torch.Tensor:
    """SPD solve: unrolled Cholesky for m <= small_dim_max, LU otherwise."""
    if a.shape[-1] <= small_dim_max:
        return batched_cholesky_solve(a, b)[0]
    return torch.linalg.solve(a, b)
