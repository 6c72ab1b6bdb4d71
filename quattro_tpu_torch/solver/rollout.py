"""Forward rollouts and the all-alpha first-accept line search.

Counterpart of ``quattro_tpu/solver/rollout.py``. Every step size is rolled
out together (``torch.func.vmap`` over alpha), then the FIRST (largest) alpha
whose cost does not exceed the current cost is taken. ``line_search_fused``
runs the rollouts as kernel K2 on CUDA (``ops/fused_rollout.py``);
``line_search_batched_fused`` and ``line_search_batched2d`` run a trajectory
batch's rollouts as one launch of the batched rollout kernel (K7 and K6).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops.fused_rollout import (
    fused_feedback_rollouts,
    fused_feedback_rollouts_batched,
    fused_feedback_rollouts_batched2d,
)

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]
LineSearchResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# Reference line-search schedule.
DEFAULT_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)


def simulate(dynamics: Dynamics, x0: torch.Tensor, u_seq: torch.Tensor) -> torch.Tensor:
    """Roll the open-loop control sequence forward: returns (H+1, n) states."""
    xs = [x0]
    for t in range(u_seq.shape[0]):
        xs.append(dynamics(xs[-1], u_seq[t]))
    return torch.stack(xs)


def trajectory_cost(
    cost: RunningCost, final_cost: FinalCost, x_seq: torch.Tensor, u_seq: torch.Tensor
) -> torch.Tensor:
    """Total cost sum_t L(x_t, u_t) + Lf(x_H)."""
    return vmap(cost)(x_seq[:-1], u_seq).sum() + final_cost(x_seq[-1])


def feedback_rollout(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    x_ref_seq: torch.Tensor,
    u_ref_seq: torch.Tensor,
    k_seq: torch.Tensor,
    big_k_seq: torch.Tensor,
    alpha: torch.Tensor,
    unroll: int = 1,
    fuse_cost: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop rollout ``u_t = u_ref_t + alpha (k_t + K_t (x_t - x_ref_t))``.

    Returns (x_seq, u_seq, total_cost). ``unroll`` is accepted for parity: it
    only re-ordered the XLA scan and changes nothing here. ``fuse_cost``
    accumulates the running cost step by step in the rollout (sequential
    summation order) instead of one sum over the stacked costs.
    """
    x = x0
    xs, us = [x0], []
    run_total = torch.zeros((), dtype=x0.dtype, device=x0.device)
    for t in range(u_ref_seq.shape[0]):
        du = k_seq[t] + big_k_seq[t] @ (x - x_ref_seq[t])
        u = u_ref_seq[t] + alpha * du
        if fuse_cost:
            run_total = run_total + cost(x, u)
        x = dynamics(x, u)
        xs.append(x)
        us.append(u)
    x_seq, u_seq = torch.stack(xs), torch.stack(us)
    if fuse_cost:
        return x_seq, u_seq, run_total + final_cost(x)
    return x_seq, u_seq, trajectory_cost(cost, final_cost, x_seq, u_seq)


def line_search(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    x_ref_seq: torch.Tensor,
    u_ref_seq: torch.Tensor,
    k_seq: torch.Tensor,
    big_k_seq: torch.Tensor,
    current_cost: torch.Tensor,
    alphas: torch.Tensor,
    unroll: int = 1,
    fuse_cost: bool = False,
) -> LineSearchResult:
    """All-alpha line search with first-accept semantics.

    Returns ``(found, chosen_alpha, new_x_seq, new_u_seq, new_cost)``; when no
    candidate is accepted the reference trajectory and current cost come back
    unchanged with ``found=False``.
    """

    def rollout(alpha):
        return feedback_rollout(
            dynamics, cost, final_cost, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq,
            alpha, unroll=unroll, fuse_cost=fuse_cost,
        )

    cand_x, cand_u, cand_cost = vmap(rollout)(alphas)
    return _first_accept_select(cand_x, cand_u, cand_cost, x_ref_seq, u_ref_seq, current_cost, alphas)


def line_search_fused(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    x_ref_seq: torch.Tensor,
    u_ref_seq: torch.Tensor,
    k_seq: torch.Tensor,
    big_k_seq: torch.Tensor,
    current_cost: torch.Tensor,
    alphas: torch.Tensor,
) -> LineSearchResult:
    """``line_search`` with the rollouts as one K2 launch (CUDA) or its plain form (CPU).

    On CUDA the dynamics must be a plant the kernel knows (``make_discrete``
    of a ``QuadrotorField`` or a ``CartPoleField``); others raise.
    """
    cand_x, cand_u = fused_feedback_rollouts(dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq, alphas)
    cand_cost = vmap(lambda xs, us: trajectory_cost(cost, final_cost, xs, us))(cand_x, cand_u)
    return _first_accept_select(cand_x, cand_u, cand_cost, x_ref_seq, u_ref_seq, current_cost, alphas)


def _batched_select(cost, final_cost, cand_x, cand_u, x_ref_batch, u_ref_batch, current_cost, alphas):
    """Candidate costs over (alpha, trajectory), then the first accept per trajectory."""
    traj_cost = lambda xs, us: trajectory_cost(cost, final_cost, xs, us)
    cand_cost = vmap(vmap(traj_cost))(cand_x, cand_u)  # (A, B)
    return vmap(_first_accept_select, in_dims=(1, 1, 1, 0, 0, 0, None))(
        cand_x, cand_u, cand_cost, x_ref_batch, u_ref_batch, current_cost, alphas
    )


def line_search_batched_fused(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0_batch: torch.Tensor,  # (B, n)
    x_ref_batch: torch.Tensor,  # (B, H+1, n)
    u_ref_batch: torch.Tensor,  # (B, H, m)
    k_batch: torch.Tensor,  # (B, H, m)
    big_k_batch: torch.Tensor,  # (B, H, m, n)
    current_cost: torch.Tensor,  # (B,)
    alphas: torch.Tensor,  # (A,)
) -> LineSearchResult:
    """``line_search`` over a trajectory batch, the rollouts in one launch (K7 on CUDA).

    Same accept semantics as ``vmap(line_search)`` over the batch; candidate
    costs and the per-trajectory first-accept select stay in PyTorch. Returns
    ``(found (B,), chosen_alpha (B,), new_x (B, H+1, n), new_u (B, H, m),
    new_cost (B,))``. The JAX function's ``interpret`` is not carried over.
    """
    cand_x, cand_u = fused_feedback_rollouts_batched(
        dynamics, x0_batch, x_ref_batch, u_ref_batch, k_batch, big_k_batch, alphas
    )
    return _batched_select(cost, final_cost, cand_x, cand_u, x_ref_batch, u_ref_batch, current_cost, alphas)


def line_search_batched2d(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0_batch: torch.Tensor,  # (B, n)
    x_ref_batch: torch.Tensor,  # (B, H+1, n)
    u_ref_batch: torch.Tensor,  # (B, H, m)
    k_batch: torch.Tensor,  # (B, H, m)
    big_k_batch: torch.Tensor,  # (B, H, m, n)
    current_cost: torch.Tensor,  # (B,)
    alphas: torch.Tensor,  # (A,)
) -> LineSearchResult:
    """``line_search_batched_fused`` through ``fused_feedback_rollouts_batched2d`` (K6 on CUDA).

    Same contract. The JAX function's ``interpret`` and ``tile_s`` (a TPU
    tile size that changes no result) are not carried over.
    """
    cand_x, cand_u = fused_feedback_rollouts_batched2d(
        dynamics, x0_batch, x_ref_batch, u_ref_batch, k_batch, big_k_batch, alphas
    )
    return _batched_select(cost, final_cost, cand_x, cand_u, x_ref_batch, u_ref_batch, current_cost, alphas)


def _first_accept_select(cand_x, cand_u, cand_cost, x_ref_seq, u_ref_seq, current_cost, alphas):
    accepted = cand_cost <= current_cost
    found = accepted.any()
    # argmax returns the first maximal entry: the first accepted (largest) alpha.
    idx = torch.argmax(accepted.to(torch.int8))

    new_x = torch.where(found, cand_x[idx], x_ref_seq)
    new_u = torch.where(found, cand_u[idx], u_ref_seq)
    new_cost = torch.where(found, cand_cost[idx], current_cost)
    chosen_alpha = torch.where(found, alphas[idx], torch.zeros_like(alphas[idx]))
    return found, chosen_alpha, new_x, new_u, new_cost
