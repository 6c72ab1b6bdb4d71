"""Infinite-horizon discrete LQR via a fixed-iteration DARE solver.

Counterpart of ``quattro_tpu/solver/lqr.py``: the structure-preserving
doubling algorithm (SDA), a fixed-iteration, branch-free method that runs
entirely on the tensors' device and converges quadratically (each sweep
squares the effective horizon, so about 30 sweeps cover 2^30 steps).
"""

from __future__ import annotations

from typing import Tuple

import torch


def solve_dare(
    a: torch.Tensor,
    b: torch.Tensor,
    q: torch.Tensor,
    r: torch.Tensor,
    iterations: int = 30,
) -> torch.Tensor:
    """Solve ``P = A'PA - A'PB (R + B'PB)^{-1} B'PA + Q`` by doubling.

    Iteration (SDA):
        A_{j+1} = A_j (I + G_j H_j)^{-1} A_j
        G_{j+1} = G_j + A_j G_j (I + H_j G_j)^{-1} A_j'
        H_{j+1} = H_j + A_j' (I + H_j G_j)^{-1} H_j A_j
    with A_0 = A, G_0 = B R^{-1} B', H_0 = Q; H_j -> P.
    """
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    a_j, g_j, h_j = a, b @ torch.linalg.solve(r, b.T), q
    for _ in range(iterations):
        lhs = eye + g_j @ h_j  # (I + G H)
        m_a = torch.linalg.solve(lhs, a_j)  # (I+GH)^{-1} A
        m_g = torch.linalg.solve(lhs, g_j)  # (I+GH)^{-1} G = G (I+HG)^{-1}
        # (I + H G)^{-1} X = solve(lhs.T, X) since (I+HG) = (I+GH)' for sym G,H
        mh_a = torch.linalg.solve(lhs.T, h_j @ a_j)
        a_next = a_j @ m_a
        g_next = g_j + a_j @ m_g @ a_j.T  # A G (I+HG)^{-1} A'
        h_next = h_j + a_j.T @ mh_a
        a_j, g_j, h_j = a_next, 0.5 * (g_next + g_next.T), 0.5 * (h_next + h_next.T)
    return h_j


def lqr_gain(
    a: torch.Tensor,
    b: torch.Tensor,
    q: torch.Tensor,
    r: torch.Tensor,
    iterations: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Infinite-horizon LQR gain ``K = (R + B'PB)^{-1} B'PA`` and P.

    ``u = -K (x - x_ref)`` is the stabilizing control.
    """
    p = solve_dare(a, b, q, r, iterations)
    k = torch.linalg.solve(r + b.T @ p @ b, b.T @ p @ a)
    return k, p
