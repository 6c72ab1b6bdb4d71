"""Batched autodiff linearization and quadratization over the horizon.

Counterpart of ``quattro_tpu/solver/derivatives.py``: every (A_t, B_t)
Jacobian and every (l_x, l_u, l_xx, l_uu, l_ux) cost expansion along a
trajectory from one ``torch.func.vmap`` of forward-mode / reverse-mode
derivatives. Arrays stacked over time carry a leading horizon axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.func import grad, hessian, jacfwd, vmap


class CostExpansion(NamedTuple):
    """Second-order expansion of the running cost; ``l_ux`` is d2L/(du dx), (H, m, n)."""

    l_x: torch.Tensor  # (H, n)
    l_u: torch.Tensor  # (H, m)
    l_xx: torch.Tensor  # (H, n, n)
    l_uu: torch.Tensor  # (H, m, m)
    l_ux: torch.Tensor  # (H, m, n)


class FinalCostExpansion(NamedTuple):
    v_x: torch.Tensor  # (n,)
    v_xx: torch.Tensor  # (n, n)


def linearize_dynamics(
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_seq: torch.Tensor,
    u_seq: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobians (A_t, B_t) of a discrete map at every step: (H, n, n), (H, n, m).

    ``x_seq`` is (H+1, n) (the last state is unused), ``u_seq`` is (H, m).
    """
    jac = jacfwd(dynamics, argnums=(0, 1))
    a_seq, b_seq = vmap(jac)(x_seq[:-1], u_seq)
    return a_seq, b_seq


def quadratize_cost(
    cost: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_seq: torch.Tensor,
    u_seq: torch.Tensor,
) -> CostExpansion:
    """Gradients and forward-over-reverse Hessians of the running cost."""
    grad_x = grad(cost, argnums=0)
    grad_u = grad(cost, argnums=1)
    hess_xx = jacfwd(grad_x, argnums=0)
    hess_uu = jacfwd(grad_u, argnums=1)
    hess_ux = jacfwd(grad_u, argnums=0)  # d/dx of dL/du -> (m, n)

    def expand(x, u):
        return grad_x(x, u), grad_u(x, u), hess_xx(x, u), hess_uu(x, u), hess_ux(x, u)

    return CostExpansion(*vmap(expand)(x_seq[:-1], u_seq))


def quadratize_final_cost(
    final_cost: Callable[[torch.Tensor], torch.Tensor],
    x_final: torch.Tensor,
) -> FinalCostExpansion:
    """Terminal value seed (V_x, V_xx) = (dLf/dx, d2Lf/dx2)."""
    return FinalCostExpansion(grad(final_cost)(x_final), hessian(final_cost)(x_final))
