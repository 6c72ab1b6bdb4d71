"""The work model of the port's kernels: bytes and operations from shapes, frozen for the benchmark.

Each function is a copy of ``chip_smoke.py``'s of the same name (the line is
named in its docstring), so a change to the program cannot move the
yardstick. Inputs are counted as read once and outputs as written once; the
operations are those the algorithm needs (2 per multiply-add; sin, cos, tan and
a division counted as one). The caller passes the trips, lanes and iterations
that the inputs actually ran, never a forced count.
"""

from __future__ import annotations

from bench_cuda.work.peaks import FLOPS, HBM_BYTES_PER_S

SIZES = {"float32": 4, "float64": 8}


def k1_work(horizon, n, m, dtype):
    """(bytes, flops) of one backward Riccati pass (``chip_smoke.py:441``)."""
    size = SIZES[dtype]
    inputs = horizon * (2 * n * n + n * m + n + m + m * m + m * n) + n + n * n
    outputs = horizon * (m + m * n) + (horizon + 1) * (n + n * n)
    step = (
        4 * n**3 + 8 * n * n * m + 2 * n * n + 2 * n * m + 2 * n * m * m  # Q-expansion
        + m**3 // 3 + 2 * m * m * (n + 1)  # Cholesky + two substitutions
        + 2 * m * m + 4 * n * n * m + 4 * n * m  # value update
    )
    return (inputs + outputs) * size, horizon * step


def k2_work(horizon, n, m, n_alpha, field_flops, dtype):
    """(bytes, flops) of one trajectory's all-alpha closed-loop rollouts (``chip_smoke.py:454``).

    The copy takes n, m and the field's flops as arguments, where the original
    fixed the quadrotor's (12, 4, 80), so the cart-pole's rollouts count too.
    """
    size = SIZES[dtype]
    inputs = n + horizon * (n + m + m + m * n) + n_alpha
    outputs = n_alpha * ((horizon + 1) * n + horizon * m)
    step = m * (2 * n + 2) + n + 4 * field_flops + 6 * n + 5 * n
    return (inputs + outputs) * size, n_alpha * horizon * step


def trip_flops(horizon, n, m, n_alpha, field_flops, dtype):
    """Flops of one iLQR iteration of one trajectory: linearize, quadratize, Riccati, all-alpha rollouts with costs."""
    linearize = horizon * ((4 * field_flops + 6 * n) + (n + m) * (4 * 2 * field_flops + 12 * n))
    quadratize = horizon * (2 * n * n + 2 * m * m + 30 * m)
    riccati = k1_work(horizon, n, m, dtype)[1]
    return linearize + quadratize + riccati + rollout_flops(horizon, n, m, n_alpha, field_flops)


def k3_work(horizon, n, m, n_alpha, trips, field_flops, dtype):
    """(bytes, flops) of one K3 solve that runs ``trips`` iterations (``chip_smoke.py:631``)."""
    size = SIZES[dtype]
    inputs = (horizon + 1) * n + horizon * m + 1 + 2 * n * n + m * m + 2 * n + n_alpha
    outputs = (horizon + 1) * n + 2 * horizon * m + horizon * m * n + 3
    return (inputs + outputs) * size, trips * trip_flops(horizon, n, m, n_alpha, field_flops, dtype)


def stage_entries(n, m):
    """Entries of one stage of K4's input (``chip_smoke.py:753``)."""
    return 2 * n * n + 2 * n * m + m * m + n + m


def k4_work(batch, horizon, n, m, dtype):
    """(bytes, flops) of the batched backward pass over ``batch`` trajectories, gains only (``chip_smoke.py:757``)."""
    size = SIZES[dtype]
    inputs = batch * (horizon * stage_entries(n, m) + n + n * n)
    outputs = batch * horizon * (m + m * n)
    return (inputs + outputs) * size, batch * k1_work(horizon, n, m, dtype)[1]


def k6_work(batch, horizon, n, m, n_alpha, field_flops, dtype):
    """(bytes, flops) of the all-alpha rollouts of ``batch`` trajectories: K7's count (``chip_smoke.py:775``)."""
    size = SIZES[dtype]
    flops = k2_work(horizon, n, m, n_alpha, field_flops, dtype)[1]
    inputs = batch * (n + (horizon + 1) * n + horizon * (2 * m + m * n)) + n_alpha
    outputs = n_alpha * batch * ((horizon + 1) * n + horizon * m)
    return (inputs + outputs) * size, batch * flops


def bound_ms(work, dtype):
    """(least ms the card could take, "bytes" or "operations"): the larger of the two (``chip_smoke.py:464``)."""
    nbytes, flops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rollout_flops(horizon, n, m, n_alpha, field_flops):
    """The all-alpha rollouts with their running costs, as ``trip_flops`` counts them."""
    step_cost = 2 * n * n + 2 * n + 2 * m * m + 2 * m + 12 * m
    return n_alpha * horizon * (m * (2 * n + 2) + n + 4 * field_flops + 11 * n + step_cost)

