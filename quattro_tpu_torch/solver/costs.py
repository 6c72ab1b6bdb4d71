"""Cost function builders (counterpart of ``quattro_tpu/solver/costs.py``).

Quadratic running/final costs with no 1/2 factor and the smooth softplus^2
control-positivity barrier. Costs are plain scalar torch functions so the
solver can quadratize them with ``torch.func.grad`` / ``jacfwd``; they also
broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import Callable

import torch

RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    return torch.diag(w) if w.ndim == 1 else w


def make_quadratic_cost(
    q: torch.Tensor,
    r: torch.Tensor,
    x_ref: torch.Tensor,
    barrier_alpha: float = 0.0,
    barrier_beta: float = 10.0,
) -> RunningCost:
    """Running cost ``dx'Q dx + u'R u (+ alpha * sum softplus(-u, beta)^2)``.

    ``q``/``r`` may be full matrices or 1-D diagonals; they are moved to
    ``x_ref``'s device and dtype.
    """
    q_mat = _as_matrix(torch.as_tensor(q, dtype=x_ref.dtype, device=x_ref.device))
    r_mat = _as_matrix(torch.as_tensor(r, dtype=x_ref.dtype, device=x_ref.device))

    def cost(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        dx = x - x_ref
        value = (dx * (dx @ q_mat.T)).sum(-1) + (u * (u @ r_mat.T)).sum(-1)
        if barrier_alpha > 0.0:
            value = value + barrier_alpha * softplus_barrier(u, barrier_beta)
        return value

    return cost


def make_quadratic_final_cost(qf: torch.Tensor, x_ref: torch.Tensor) -> FinalCost:
    """Terminal cost ``dx'Qf dx`` (no 1/2 factor)."""
    qf_mat = _as_matrix(torch.as_tensor(qf, dtype=x_ref.dtype, device=x_ref.device))

    def cost(x: torch.Tensor) -> torch.Tensor:
        dx = x - x_ref
        return (dx * (dx @ qf_mat.T)).sum(-1)

    return cost


def softplus_stable(z: torch.Tensor, beta: float) -> torch.Tensor:
    """``log1p(exp(beta z))/beta`` in the overflow-safe form.

    The values are those of ``max(z, 0) + log1p(exp(-|beta z|))/beta``, written
    per branch so that autodiff gives the analytic derivatives
    (``sigmoid(beta z)`` and onwards) at every z: the literal max/abs
    expression differentiates to 1, not 1/2, at z = 0, which is where a solve
    from zero controls starts. Each branch sees only its own half-line, so
    neither ``exp`` overflows and no NaN reaches the unselected gradient.
    (``F.logsigmoid`` is avoided: its CUDA kernel returns an empty buffer that
    ``torch.func.vmap`` cannot batch.)
    """
    z_neg = torch.clamp(z, max=0.0)
    z_pos = torch.clamp(z, min=0.0)
    negative = torch.log1p(torch.exp(beta * z_neg)) / beta
    positive = z_pos + torch.log1p(torch.exp(-beta * z_pos)) / beta
    return torch.where(z <= 0.0, negative, positive)


def softplus_barrier(u: torch.Tensor, beta: float = 10.0) -> torch.Tensor:
    """Smooth penalty for u < 0: ``sum softplus(-u, beta)^2`` over the last axis."""
    return (softplus_stable(-u, beta) ** 2).sum(-1)
