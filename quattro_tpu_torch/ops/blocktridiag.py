"""Symmetric block-tridiagonal matrices: the trajectory KKT structure (kernel K9).

Counterpart of ``quattro_tpu/ops/blocktridiag.py``. The Newton/KKT system of
the trajectory QP is block-sparse; eliminating the controls and states
locally leaves a symmetric positive-definite block-tridiagonal system in the
dynamics multipliers (the "dual Schur complement"), whose block Cholesky
factorization is Riccati-equivalent. This module holds the matrix type, the
block-banded SpMV, the KKT assembly from an LQ subproblem, a block-Thomas
solve, the primal recovery and the residual, with the block-nnz accounting.

The SpMV ``btd_matvec`` is kernel K9 on CUDA tensors (``btd_matvec_fused``,
one launch of ``csrc/btd_matvec.cu``) and its plain three-product form
``btd_matvec_plain`` on CPU tensors; ``kkt_residual`` is one launch of the
same kernel, which reduces the residual per block row in place of writing y.

Derivation of ``build_lqr_kkt`` (stage data cross-term-eliminated as in
``solver/riccati.py::_stage_elements``, so stages are
``0.5 dx' ltil_xx dx + ltil_x' dx + 0.5 w' l_uu w`` with dynamics
``dx_{t+1} = Atil_t dx_t + B_t w_t + b_t``, ``dx_0 = 0``):

    w_t   = -l_uu^{-1} B_t' lam_{t+1}
    dx_t  = Z_t (lam_t - ltil_x_t - Atil_t' lam_{t+1}),   Z_t = ltil_xx_t^{-1}
    dx_H  = Z_H (lam_H - v_x),                            Z_H = V_xx^{-1}

substituted into the constraints gives, for rows r = 1..H (lam_r):

    -Atil_{r-1} Z_{r-1} lam_{r-1}
    + (Z_r + Atil_{r-1} Z_{r-1} Atil_{r-1}' + W_{r-1}) lam_r
    - Z_r Atil_r' lam_{r+1}
    = b_{r-1} - Atil_{r-1} Z_{r-1} ltil_x_{r-1} + Z_r ltil_x_r

with ``W_t = B_t l_uu^{-1} B_t'``, ``Z_0 = 0`` and ``ltil_x_H := v_x``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from quattro_tpu_torch.ops import _build, contract
from quattro_tpu_torch.solver.derivatives import CostExpansion

KERNEL = "btd_matvec"
_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6  # qt_btd_matvec


class BlockTridiagonal(NamedTuple):
    """Symmetric block-tridiagonal matrix.

    ``diag``: (N, n, n) diagonal blocks D_0..D_{N-1};
    ``lower``: (N-1, n, n) sub-diagonal blocks; block (t+1, t) is ``lower[t]``
    and block (t, t+1) is ``lower[t]^T``.
    """

    diag: torch.Tensor
    lower: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.diag.shape[0]

    @property
    def block_nnz(self) -> int:
        """Nonzero block count (diagonal and both bands), the unit of block-nnz/s."""
        return self.diag.shape[0] + 2 * self.lower.shape[0]


def btd_matvec_plain(mat: BlockTridiagonal, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of K9: y = M x for block vectors x (N, n), three batched block products."""
    n = x.shape[-1]
    zero = x.new_zeros((1, n))
    y = torch.einsum("tij,tj->ti", mat.diag, x)
    lo = torch.einsum("tij,tj->ti", mat.lower, x[:-1])  # block (t+1, t) @ x_t
    up = torch.einsum("tji,tj->ti", mat.lower, x[1:])  # block (t, t+1) @ x_{t+1}
    return y + torch.cat([zero, lo]) + torch.cat([up, zero])


def _launch(mat: BlockTridiagonal, x: torch.Tensor, rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K9 launch: y = M x (N, n), or with ``rhs`` the residual max_i |(M x - rhs)_t,i| (N,).

    At the KKT route's N = 1,024 the host's work per call takes longer than
    the kernel, so the checks are one expression of attribute reads. Strided
    inputs are copied (``build_lqr_kkt``'s diagonal blocks come out
    transposed in memory).
    """
    diag, lower = mat.diag, mat.lower
    dtype = contract.DTYPES.get(diag.dtype)
    shape = diag.shape
    if dtype is None or len(shape) != 3 or shape[1] != shape[2] or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"{KERNEL}: expected float32 or float64 diag (N, n, n) with N, n >= 1, "
                         f"got {tuple(shape)} {diag.dtype}")
    num_blocks, n, _ = shape
    device = diag.get_device()
    if (lower.shape != (num_blocks - 1, n, n) or x.shape != (num_blocks, n)
            or lower.dtype is not diag.dtype or x.dtype is not diag.dtype or lower.get_device() != device
            or x.get_device() != device or rhs is not None and (
                rhs.shape != x.shape or rhs.dtype is not x.dtype or rhs.get_device() != device)):
        raise ValueError(f"{KERNEL}: expected lower ({num_blocks - 1}, {n}, {n}), x and rhs ({num_blocks}, {n}), "
                         f"all {diag.dtype} on {diag.device}; got lower {tuple(lower.shape)} {lower.dtype} on "
                         f"{lower.device}, x {tuple(x.shape)} {x.dtype} on {x.device}, rhs "
                         f"{None if rhs is None else (tuple(rhs.shape), rhs.dtype, rhs.device)}")
    diag, lower, x = diag.contiguous(), lower.contiguous(), x.contiguous()
    if rhs is None:
        out, rhs_ptr = torch.empty_like(x), None
    else:
        rhs = rhs.contiguous()
        out, rhs_ptr = x.new_empty(num_blocks), rhs.data_ptr()
    fn = _build.bind(KERNEL, "qt_btd_matvec", ctypes.c_int, _ARGTYPES)
    _build.launch(KERNEL, fn, device, dtype, num_blocks, n, diag.data_ptr(),
                  lower.data_ptr() if num_blocks > 1 else None, x.data_ptr(), rhs_ptr, out.data_ptr())
    return out


def btd_matvec_fused(mat: BlockTridiagonal, x: torch.Tensor) -> torch.Tensor:
    """The block-banded SpMV, counterpart of ``quattro_tpu/ops/blocktridiag.py::btd_matvec_pallas``.

    CUDA tensors launch K9 once (float32 or float64, any N, n >= 1; anything
    else raises ``ValueError``); CPU tensors take the plain form.
    The TPU kernel's band stacking, structure-of-arrays transposes and lane
    padding have no counterpart: the kernel stages tiles of block rows from
    where the bands lie.
    """
    return contract.on_device(KERNEL, mat.diag, _launch, btd_matvec_plain, mat, x)


btd_matvec = btd_matvec_fused  # JAX's public name for the SpMV: K9 on CUDA, the plain form on the CPU


class LQRKKTSystem(NamedTuple):
    """Dual-Schur KKT system M lam = rhs plus the data to recover (dx, w)."""

    matrix: BlockTridiagonal
    rhs: torch.Tensor  # (H, n)
    z_seq: torch.Tensor  # (H, n, n): Z_1..Z_H (stage-Hessian inverses)
    a_til: torch.Tensor  # (H, n, n)
    ltil_x: torch.Tensor  # (H+1, n): ltil_x_0..ltil_x_{H-1}, v_x


def _mv(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", mat, vec)


def build_lqr_kkt(
    a_seq: torch.Tensor,  # (H, n, n)
    b_seq: torch.Tensor,  # (H, n, m)
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
) -> LQRKKTSystem:
    """Assemble the SPD dual-Schur block-tridiagonal system of an LQ problem.

    See the module docstring for the derivation. ``reg`` regularizes l_uu (as
    in the associative Riccati form) and the stage-Hessian inverses.
    """
    horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    eye_m = torch.eye(m, dtype=a_seq.dtype, device=a_seq.device)
    eye_n = torch.eye(n, dtype=a_seq.dtype, device=a_seq.device)
    l_x, l_u, l_xx, l_uu, l_ux = cost_exp
    b_t = b_seq.transpose(-1, -2)
    l_ux_t = l_ux.transpose(-1, -2)

    rhs = torch.cat([l_u[..., None], l_ux, b_t], dim=-1)  # (H, m, 1+n+n)
    sol = torch.linalg.solve(l_uu + reg * eye_m, rhs)
    luu_inv_lu, luu_inv_lux, luu_inv_bt = sol[..., 0], sol[..., 1 : 1 + n], sol[..., 1 + n :]
    a_til = a_seq - b_seq @ luu_inv_lux
    w_seq = b_seq @ luu_inv_bt
    b_off = -_mv(b_seq, luu_inv_lu)
    ltil_x = l_x - _mv(l_ux_t, luu_inv_lu)
    ltil_xx = l_xx - l_ux_t @ luu_inv_lux

    # Z_r = inverse stage Hessian at rows 1..H (the terminal block for r = H).
    h_blocks = torch.cat([ltil_xx[1:], v_xx_final[None]], dim=0)  # (H, n, n)
    z_seq = torch.linalg.inv(h_blocks + reg * eye_n)

    # ltil_x at rows 0..H with the terminal gradient appended.
    grad_seq = torch.cat([ltil_x, v_x_final[None]], dim=0)  # (H+1, n)

    z_prev = torch.cat([a_seq.new_zeros((1, n, n)), z_seq[:-1]], dim=0)
    diag = z_seq + a_til @ z_prev @ a_til.transpose(-1, -2) + w_seq
    lower = -(a_til[1:] @ z_seq[:-1])
    rhs = b_off - _mv(a_til @ z_prev, grad_seq[:-1]) + _mv(z_seq, grad_seq[1:])
    return LQRKKTSystem(
        matrix=BlockTridiagonal(diag=diag, lower=lower),
        rhs=rhs,
        z_seq=z_seq,
        a_til=a_til,
        ltil_x=grad_seq,
    )


def btd_solve(mat: BlockTridiagonal, rhs: torch.Tensor) -> torch.Tensor:
    """Block-Thomas (block Cholesky) solve of the SPD system M x = rhs.

    A loop over the N blocks, forward then backward, as JAX's two scans
    (with the same identity "virtual" block before the first); a few small
    launches per block on the card. The horizon-parallel route is the
    associative scan in ``solver/riccati.py``.
    """
    num_blocks, n, _ = mat.diag.shape
    zeros_block = mat.diag.new_zeros((n, n))
    s_prev = torch.eye(n, dtype=mat.diag.dtype, device=mat.diag.device)
    y_prev = mat.diag.new_zeros((n,))
    s_seq, y_seq = [], []
    for t in range(num_blocks):
        e = mat.lower[t - 1] if t > 0 else zeros_block  # coupling to the previous block
        # Schur update: S_t = D_t - E_{t-1} S_{t-1}^{-1} E_{t-1}^T
        gain = torch.linalg.solve(s_prev, e.T).T  # E S^{-1}
        s_prev = mat.diag[t] - gain @ e.T
        y_prev = rhs[t] - gain @ y_prev
        s_seq.append(s_prev)
        y_seq.append(y_prev)
    x_next = mat.diag.new_zeros((n,))
    x_seq: list = [None] * num_blocks
    for t in reversed(range(num_blocks)):
        e_next = mat.lower[t] if t + 1 < num_blocks else zeros_block  # lower[t] couples x_{t+1} with x_t
        x_next = torch.linalg.solve(s_seq[t], y_seq[t] - e_next.T @ x_next)
        x_seq[t] = x_next
    return torch.stack(x_seq)


def recover_primal(system: LQRKKTSystem, lam: torch.Tensor) -> torch.Tensor:
    """The state perturbations dx_1..dx_H from the multipliers lam_1..lam_H.

    dx_r = Z_r (lam_r - ltil_x_r - Atil_r' lam_{r+1}), with lam_{H+1} = 0 and
    ltil_x_H = v_x.
    """
    lam_next = torch.cat([lam[1:], lam.new_zeros((1, lam.shape[-1]))], dim=0)
    a_til_rows = torch.cat([system.a_til[1:], torch.zeros_like(system.a_til[:1])], dim=0)
    inner = lam - system.ltil_x[1:] - torch.einsum("tji,tj->ti", a_til_rows, lam_next)
    return torch.einsum("tij,tj->ti", system.z_seq, inner)


def kkt_residual(mat: BlockTridiagonal, solution: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """||M z - r||_inf per block row (factorization-quality telemetry).

    CUDA tensors: one K9 launch, which reduces |M z - r| over each block row
    in the kernel; CPU tensors: the plain form.
    """
    return contract.on_device(KERNEL, mat.diag, _launch, _kkt_residual_plain, mat, solution, rhs)


def _kkt_residual_plain(mat: BlockTridiagonal, solution: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return (btd_matvec_plain(mat, solution) - rhs).abs().amax(dim=-1)
