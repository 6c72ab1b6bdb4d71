"""Cost function builders (counterpart of ``quattro_tpu/solver/costs.py``).

Quadratic running/final costs with no 1/2 factor and the smooth softplus^2
control-positivity barrier. Costs are scalar torch callables so the solver
can quadratize them with ``torch.func.grad`` / ``jacfwd``; they also broadcast
over leading batch dimensions. ``make_quadratic_cost`` and
``make_quadratic_final_cost`` return small callable objects
(``QuadraticRunningCost``, ``QuadraticFinalCost``) that carry their tables
and a ``kind``, as ``make_discrete`` does for the plant, so a CUDA kernel's
wrapper can read what it cannot trace. ``QuadraticCost`` is the JAX
package's diagonal-weight spec under its name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple

import torch

RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]


class QuadraticCost(NamedTuple):
    """Diagonal-weight quadratic tracking cost spec (JAX's ``QuadraticCost``)."""

    q_diag: torch.Tensor  # (n,) state weights
    r_diag: torch.Tensor  # (m,) control weights
    qf_diag: torch.Tensor  # (n,) terminal state weights


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    return torch.diag(w) if w.ndim == 1 else w


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class QuadraticRunningCost:
    """Running cost ``dx'Q dx + u'R u (+ alpha * sum softplus(-u, beta)^2)`` as a callable.

    It carries its tables, so the whole-solve kernel (``ops/fused_solve.py``),
    which cannot trace a Python callable, can read them.
    """

    q_mat: torch.Tensor  # (n, n)
    r_mat: torch.Tensor  # (m, m)
    x_ref: torch.Tensor  # (n,)
    barrier_alpha: float = 0.0
    barrier_beta: float = 10.0
    kind: ClassVar[str] = "quadratic"

    def __repr__(self) -> str:
        # Without the tables: torch.func.vmap names a callable object by its
        # repr on every call, and printing CUDA tensors reads them back.
        return (f"QuadraticRunningCost(n={self.q_mat.shape[0]}, m={self.r_mat.shape[0]}, "
                f"barrier_alpha={self.barrier_alpha}, barrier_beta={self.barrier_beta})")

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        dx = x - self.x_ref
        value = (dx * (dx @ self.q_mat.T)).sum(-1) + (u * (u @ self.r_mat.T)).sum(-1)
        if self.barrier_alpha > 0.0:
            value = value + self.barrier_alpha * softplus_barrier(u, self.barrier_beta)
        return value


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class QuadraticFinalCost:
    """Terminal cost ``dx'Qf dx`` as a callable that carries its tables."""

    qf_mat: torch.Tensor  # (n, n)
    x_ref: torch.Tensor  # (n,)
    kind: ClassVar[str] = "quadratic_final"

    def __repr__(self) -> str:
        return f"QuadraticFinalCost(n={self.qf_mat.shape[0]})"  # see QuadraticRunningCost.__repr__

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        dx = x - self.x_ref
        return (dx * (dx @ self.qf_mat.T)).sum(-1)


def make_quadratic_cost(
    q: torch.Tensor,
    r: torch.Tensor,
    x_ref: torch.Tensor,
    barrier_alpha: float = 0.0,
    barrier_beta: float = 10.0,
) -> QuadraticRunningCost:
    """Running cost ``dx'Q dx + u'R u (+ alpha * sum softplus(-u, beta)^2)``.

    ``q``/``r`` may be full matrices or 1-D diagonals; they are moved to
    ``x_ref``'s device and dtype.
    """
    q_mat = _as_matrix(torch.as_tensor(q, dtype=x_ref.dtype, device=x_ref.device))
    r_mat = _as_matrix(torch.as_tensor(r, dtype=x_ref.dtype, device=x_ref.device))
    return QuadraticRunningCost(q_mat, r_mat, x_ref, float(barrier_alpha), float(barrier_beta))


def make_quadratic_final_cost(qf: torch.Tensor, x_ref: torch.Tensor) -> QuadraticFinalCost:
    """Terminal cost ``dx'Qf dx`` (no 1/2 factor)."""
    qf_mat = _as_matrix(torch.as_tensor(qf, dtype=x_ref.dtype, device=x_ref.device))
    return QuadraticFinalCost(qf_mat, x_ref)


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
