"""Batched Cholesky factorize-and-solve for tiny SPD systems (kernel K8).

Counterpart of ``quattro_tpu/ops/smallchol.py``:

- the pure forms: the Cholesky-Crout factorization and both triangular
  solves unrolled over the small matrix dimension m, batched over leading
  dimensions (``batched_cholesky_solve``, ``batched_spd_solve``);
- ``batched_cholesky_solve_fused``, the counterpart of the TPU kernel
  ``batched_cholesky_solve_pallas``: on CUDA tensors one launch of
  ``csrc/batched_cholesky.cu`` (K8) solves every system of the batch; on CPU
  tensors its plain form ``batched_cholesky_solve_plain`` runs.

``batched_spd_solve`` stays the plain unrolled form, as JAX's is: it is
called under ``torch.func.vmap`` (the sequential Riccati law of the batched
solve's ``"vmap"`` backend), where a kernel launched through ctypes cannot
run. The associative Riccati form calls K8 by name on whole (..., H) batches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from quattro_tpu_torch.ops import _build, contract

KERNEL = "batched_cholesky"
SMALL_DIM_MAX = 8  # batched_spd_solve's small_dim_max, and K8's largest m
_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4  # qt_batched_cholesky


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


def batched_spd_solve(a: torch.Tensor, b: torch.Tensor, small_dim_max: int = SMALL_DIM_MAX) -> torch.Tensor:
    """SPD solve: unrolled Cholesky for m <= small_dim_max, LU otherwise."""
    if a.shape[-1] <= small_dim_max:
        return batched_cholesky_solve(a, b)[0]
    return torch.linalg.solve(a, b)


def batched_cholesky_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of K8: the unrolled Cholesky-Crout solve, ``x (B, m, r)``."""
    return batched_cholesky_solve(a, b)[0]


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() != 3 or b.dim() != 3 or a.shape[1] != a.shape[2] or b.shape[:2] != a.shape[:2]:
        raise ValueError(f"{KERNEL}: expected a (B, m, m) and b (B, m, r), got {tuple(a.shape)} and {tuple(b.shape)}")
    batch, m, r = b.shape
    if not 1 <= m <= SMALL_DIM_MAX:
        raise ValueError(f"{KERNEL} takes 1 <= m <= {SMALL_DIM_MAX}, got m={m} (larger systems: torch.linalg.solve)")
    dtype = contract.DTYPES.get(a.dtype)
    if dtype is None or b.dtype != a.dtype:
        raise ValueError(f"{KERNEL} takes float32 or float64 a and b of one dtype, got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"{KERNEL}: a on {a.device}, b on {b.device}")
    a, b = a.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    if batch == 0 or r == 0:
        return x
    fn = _build.bind(KERNEL, "qt_batched_cholesky", ctypes.c_int, _ARGTYPES)
    _build.launch(KERNEL, fn, a.device, dtype, batch, m, r, a.data_ptr(), b.data_ptr(), x.data_ptr())
    return x


def batched_cholesky_solve_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a batch of tiny SPD systems: a (B, m, m), b (B, m, r) -> x (B, m, r), any B.

    Counterpart of ``quattro_tpu/ops/smallchol.py::batched_cholesky_solve_pallas``.
    CUDA tensors launch K8 once (float32 or float64, 1 <= m <= 8, any r;
    anything else raises ``ValueError``); CPU tensors take the plain form.
    The TPU kernel's identity padding and SoA transposes have no counterpart:
    the kernel stages tiles of systems in their natural layout through shared
    memory and bounds-checks the last tile.
    """
    return contract.on_device(KERNEL, a, _launch, batched_cholesky_solve_plain, a, b)
