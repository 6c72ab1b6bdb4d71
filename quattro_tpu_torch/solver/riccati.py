"""Riccati backward passes (counterpart of ``quattro_tpu/solver/riccati.py``).

- ``riccati_backward``: the sequential recursion with the reference update
  law (Tikhonov ``reg`` on Q_uu in the solve only, value update with raw
  Q_uu, V_xx symmetrized).
- ``riccati_backward_fused``: the single-trajectory fused pass, kernel K1 on
  CUDA (``ops/fused_riccati.py``).
- ``riccati_backward_auto``: the card's dispatch (see its docstring).

The associative-scan form is not ported yet: ``riccati_backward_associative``
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quattro_tpu_torch.ops.fused_riccati import MAX_M, MAX_N, riccati_backward_fused_single
from quattro_tpu_torch.ops.smallchol import batched_spd_solve
from quattro_tpu_torch.solver.derivatives import CostExpansion

ASSOC_TODO = "ROADMAP.md, Queue 1 item 6: the associative-scan Riccati form is not ported yet"


class RiccatiResult(NamedTuple):
    k_seq: torch.Tensor  # (H, m) feedforward
    big_k_seq: torch.Tensor  # (H, m, n) feedback gains
    v_x_seq: torch.Tensor  # (H+1, n) value gradients, v_x_seq[t] = V_x at step t
    v_xx_seq: torch.Tensor  # (H+1, n, n) value Hessians


def _q_expansion(a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx):
    """One-step Q expansion."""
    q_x = l_x + a.T @ v_x
    q_u = l_u + b.T @ v_x
    q_xx = l_xx + a.T @ v_xx @ a
    q_ux = l_ux + b.T @ v_xx @ a
    q_uu = l_uu + b.T @ v_xx @ b
    return q_x, q_u, q_xx, q_ux, q_uu


def _gains_and_value(q_x, q_u, q_xx, q_ux, q_uu, reg, use_chol: bool = True):
    """Gains from regularized Q_uu; value update with unregularized Q_uu, symmetrized."""
    m = q_uu.shape[0]
    q_uu_reg = q_uu + reg * torch.eye(m, dtype=q_uu.dtype, device=q_uu.device)
    rhs = torch.cat([q_u[:, None], q_ux], dim=1)  # (m, 1+n)
    solve = batched_spd_solve if use_chol else torch.linalg.solve
    sol = -solve(q_uu_reg, rhs)
    k = sol[:, 0]
    big_k = sol[:, 1:]

    v_x = q_x + big_k.T @ q_uu @ k + big_k.T @ q_u + q_ux.T @ k
    v_xx = q_xx + big_k.T @ q_uu @ big_k + big_k.T @ q_ux + q_ux.T @ big_k
    v_xx = 0.5 * (v_xx + v_xx.T)
    return k, big_k, v_x, v_xx


def riccati_backward(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Sequential backward Riccati over the full horizon (a Python loop over H)."""
    horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    k_seq = a_seq.new_empty((horizon, m))
    big_k_seq = a_seq.new_empty((horizon, m, n))
    v_x_seq = a_seq.new_empty((horizon + 1, n))
    v_xx_seq = a_seq.new_empty((horizon + 1, n, n))
    v_x, v_xx = v_x_final, v_xx_final
    v_x_seq[horizon] = v_x
    v_xx_seq[horizon] = v_xx
    for t in reversed(range(horizon)):
        q = _q_expansion(
            a_seq[t], b_seq[t], cost_exp.l_x[t], cost_exp.l_u[t], cost_exp.l_xx[t],
            cost_exp.l_uu[t], cost_exp.l_ux[t], v_x, v_xx,
        )
        k, big_k, v_x, v_xx = _gains_and_value(*q, reg, use_chol)
        k_seq[t], big_k_seq[t], v_x_seq[t], v_xx_seq[t] = k, big_k, v_x, v_xx
    return RiccatiResult(k_seq, big_k_seq, v_x_seq, v_xx_seq)


def riccati_backward_associative(*args, **kwargs) -> RiccatiResult:
    raise NotImplementedError(ASSOC_TODO)


def riccati_backward_fused(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Single-trajectory fused backward pass: kernel K1 on CUDA, its plain form on the CPU.

    ``use_chol`` is accepted for signature parity; the fused form always uses
    the unrolled Cholesky. ``reg`` is a kernel argument, not a compiled constant.
    """
    return RiccatiResult(
        *riccati_backward_fused_single(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, float(reg))
    )


def riccati_backward_auto(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
    batch_size: int = 1,
) -> RiccatiResult:
    """Pick the backward-pass form for the device and the workload.

    On the card a single trajectory takes K1 whenever the kernel takes the
    shape (n <= 16, m <= 8): it is one launch for the whole horizon, where
    the sequential form issues a few dozen small launches per step, so no
    horizon favours the sequential form. Everything else -- CPU tensors,
    batched callers, larger shapes -- takes ``riccati_backward``. The TPU
    threshold (associative scan from H >= 16) is not carried over: that form
    is not ported, and its crossover was a property of the TPU.
    """
    n = a_seq.shape[-1]
    m = b_seq.shape[-1]
    if a_seq.is_cuda and batch_size == 1 and n <= MAX_N and m <= MAX_M:
        return riccati_backward_fused(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, use_chol)
    return riccati_backward(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, use_chol)
