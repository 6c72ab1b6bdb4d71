"""Unrolled LU factor-and-solve for batches of small well-conditioned systems.

Counterpart of ``quattro_tpu/ops/smalllu.py``, which the associative
Riccati combine (``solver/riccati.py::_combine``) uses for its two n x n
solves. The elimination is unrolled over the (small) matrix dimension in the
same **dense masked** form: every step is a full-matrix elementwise op or a
row-times-block contraction, with constant boolean masks selecting the active
triangle, batched over any leading dimensions.

No pivoting, as in JAX: the combine's left-hand side is ``I + C J`` with C, J
PSD, whose spectrum ``1 + eig(C^{1/2} J C^{1/2}) >= 1`` keeps growth benign;
the combine's accuracy argument rests on this exact elimination, so it is not
replaced by a pivoting library solve. ``refine_steps`` rounds of iterative
refinement recover the last float32 digits where needed.

Both ``A x = b`` and ``A^T y = c`` reuse one factorization: A = L U gives
``A^T = U^T L^T`` (forward-substitute the lower-triangular U^T, then
back-substitute the unit-upper L^T).
"""

from __future__ import annotations

import torch


def _index(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def unrolled_lu(a: torch.Tensor) -> torch.Tensor:
    """Doolittle LU without pivoting of (..., n, n) matrices.

    Returns packed factors (..., n, n): the strictly lower part holds the
    unit-lower multipliers L, the diagonal and upper part hold U.
    """
    n = a.shape[-1]
    idx = _index(n, a.device)
    zero = a.new_zeros(())
    for k in range(n - 1):
        piv = a[..., k, k][..., None]  # (..., 1)
        mult = torch.where(idx > k, a[..., :, k] / piv, zero)  # (..., n) L column k
        row = torch.where(idx > k, a[..., k, :], zero)  # (..., n) U row k, cols > k
        # Schur update of the trailing block, then the multipliers into column k
        # (the masked outer product leaves column k untouched).
        a = a - mult[..., :, None] * row[..., None, :]
        col_k_mask = (idx > k)[:, None] & (idx == k)[None, :]  # (n, n)
        a = torch.where(col_k_mask, mult[..., :, None], a)
    return a


def lu_solve(lu: torch.Tensor, b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Solve A x = b (or A^T x = b) from ``unrolled_lu``'s packed factors; b is (..., n, r)."""
    n = lu.shape[-1]
    idx = _index(n, lu.device)
    zero = lu.new_zeros(())

    def row_contract(mat_row, x):
        # (..., n) x (..., n, r) -> (..., r)
        return torch.einsum("...j,...jr->...r", mat_row, x)

    def set_row(x, i, value):
        # Dense row write: (..., n, r) with row i replaced by value (..., r).
        return torch.where((idx == i)[:, None], value[..., None, :], x)

    if not transpose:
        # L y = b (unit lower, multipliers below the diagonal), then U x = y.
        for i in range(1, n):
            l_row = torch.where(idx < i, lu[..., i, :], zero)
            b = set_row(b, i, b[..., i, :] - row_contract(l_row, b))
        for i in reversed(range(n)):
            u_row = torch.where(idx > i, lu[..., i, :], zero)
            val = (b[..., i, :] - row_contract(u_row, b)) / lu[..., i, i][..., None]
            b = set_row(b, i, val)
        return b
    # A^T = U^T L^T: U^T y = b (lower, diagonal of U), then L^T x = y (unit upper).
    for i in range(n):
        ut_row = torch.where(idx < i, lu[..., :, i], zero)  # column i of U, above the diagonal
        val = (b[..., i, :] - row_contract(ut_row, b)) / lu[..., i, i][..., None]
        b = set_row(b, i, val)
    for i in reversed(range(n - 1)):
        lt_row = torch.where(idx > i, lu[..., :, i], zero)  # column i of L, below the diagonal
        b = set_row(b, i, b[..., i, :] - row_contract(lt_row, b))
    return b


def batched_small_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    transpose: bool = False,
    refine_steps: int = 1,
) -> torch.Tensor:
    """Solve batches of small systems A x = b (or A^T x = b).

    One unrolled factorization, the triangular solves, then ``refine_steps``
    rounds of iterative refinement (a residual product and a re-solve through
    the same factors).
    """
    factors = unrolled_lu(a)
    x = lu_solve(factors, b, transpose=transpose)
    a_eff = a.transpose(-1, -2) if transpose else a
    for _ in range(refine_steps):
        r = b - a_eff @ x
        x = x + lu_solve(factors, r, transpose=transpose)
    return x
