"""Port parity: the whole-solve kernel's plain form against quattro_tpu's megakernel.

The JAX side runs ``ilqr_solve_fused`` with its Pallas kernel in interpret
mode, as ``tests/test_fused_solve.py`` does; the port runs the plain PyTorch
form of K3 (CPU tensors never reach the CUDA kernel). Problems are the JAX
tests' own: cart-pole H=16 and quadrotor H=20, RK4, float64.

Tolerances: x, u and cost rtol 1e-8 (same step law, same summation order, two
autodiff implementations); gains K rtol 1e-7 on their scale; the feedforward k
vanishes at the optimum, so it is held to 1e-7 of the controls' scale.
Iterations and the convergence flag must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build, fused_solve

RTOL = 1e-8
GAIN_TOL = 1e-7
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


def problems(name):
    """(jax tuple, torch tuple), each (dyn, cost, fcost, x0, u0)."""
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    if name == "cartpole":
        q, r, qf = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
        x_ref, x0, u0 = np.zeros(4), np.array([0.15, 0.0, 0.2, 0.0]), np.zeros((16, 1))
        jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
        tdyn = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4")
        barrier = 0.0
    else:
        q, r, qf = Q, [0.01] * 4, QF
        x_ref, x0, u0 = np.zeros(12), np.zeros(12), np.zeros((20, 4))
        x_ref[2], x0[2], x0[6] = 0.5, 0.2, 0.1
        jdyn = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4")
        tdyn = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4")
        barrier = 1000.0
    jprob = (
        jdyn,
        jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jnp.asarray(x_ref), barrier_alpha=barrier),
        jsolver.make_quadratic_final_cost(jnp.asarray(qf), jnp.asarray(x_ref)),
        jnp.asarray(x0),
        jnp.asarray(u0),
    )
    tprob = (
        tdyn,
        tsolver.make_quadratic_cost(t(q), t(r), t(x_ref), barrier_alpha=barrier),
        tsolver.make_quadratic_final_cost(t(qf), t(x_ref)),
        t(x0),
        t(u0),
    )
    return jprob, tprob


def close_solution(ref, out, rtol=RTOL):
    assert int(out.iterations) == int(ref.iterations)
    assert bool(out.converged) == bool(ref.converged)
    for name in ("x_seq", "u_seq", "cost"):
        expected = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(np.asarray(getattr(out, name)), expected, rtol=rtol, atol=1e-10, err_msg=name)
    big_k = np.asarray(ref.big_k_seq)
    np.testing.assert_allclose(np.asarray(out.big_k_seq), big_k, rtol=GAIN_TOL, atol=GAIN_TOL * np.abs(big_k).max())
    scale = max(np.abs(np.asarray(ref.u_seq)).max(), np.abs(np.asarray(ref.k_seq)).max(), 1.0)
    np.testing.assert_allclose(np.asarray(out.k_seq), np.asarray(ref.k_seq), rtol=0.0, atol=GAIN_TOL * scale)


# (problem, tol, max_iter): forced trips, and runs whose `done` mask sets before the last trip.
CONFIGS = [
    ("cartpole", 0.0, 3),
    ("cartpole", 1e-1, 5),
    ("quadrotor", 0.0, 3),
    ("quadrotor", 60.0, 4),
]


@pytest.mark.parametrize("name,tol,max_iter", CONFIGS)
def test_plain_k3_matches_jax_megakernel(name, tol, max_iter):
    jprob, tprob = problems(name)
    ref = jsolver.ilqr_solve_fused(*jprob, jsolver.ILQRConfig(tol=tol, max_iter=max_iter))
    _build.reset_launches()
    out = tsolver.ilqr_solve_fused(*tprob, tsolver.ILQRConfig(tol=tol, max_iter=max_iter))
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    if tol > 0.0:
        assert bool(out.converged) and out.iterations < max_iter  # the mask discarded later trips
    else:
        assert out.iterations == max_iter and not out.converged
    close_solution(ref, out)


@pytest.mark.parametrize("name,tol,max_iter", CONFIGS)
def test_plain_k3_leaves_at_done_as_a_solve_of_exactly_its_iterations(monkeypatch, name, tol, max_iter):
    """The plain form runs the trips its solve needs, one linearization each, and its outputs equal, bit for bit,
    those of a solve given exactly that many trips, which has none to skip."""
    _, (dyn, cost, fcost, x0, u0) = problems(name)
    trips, linearize = [], fused_solve.linearize_dynamics
    monkeypatch.setattr(fused_solve, "linearize_dynamics", lambda *args: trips.append(1) or linearize(*args))
    config = tsolver.ILQRConfig()
    solve = lambda budget: fused_solve.fused_ilqr_solve_from_x0(dyn, cost, fcost, x0, u0, budget, tol, config.reg,
                                                                config.alphas)
    out = solve(max_iter)
    iterations = int(out[4][0, 1])
    assert len(trips) == iterations and (iterations < max_iter) == (tol > 0.0)
    assert all(torch.equal(o, e) for o, e in zip(out, solve(iterations)))


@pytest.mark.parametrize("name,tol,max_iter", CONFIGS)
def test_plain_k3_matches_the_ports_while_solve(name, tol, max_iter):
    """Against ``ilqr_solve`` with the same fused step law (``riccati="fused"``); the
    line search there sums the stacked costs, here step by step: rtol 1e-8 still holds."""
    _, tprob = problems(name)
    ref = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(tol=tol, max_iter=max_iter, riccati="fused"))
    out = tsolver.ilqr_solve_fused(*tprob, tsolver.ILQRConfig(tol=tol, max_iter=max_iter))
    close_solution(ref, out)


@pytest.mark.parametrize("name,tol,max_iter", CONFIGS)
def test_from_x0_plain_form_is_simulate_time_ordered_cost_and_plain_k3(name, tol, max_iter):
    """The x0 entry's plain form is ``simulate``, the running costs added step by step and the final cost last,
    then the plain K3, exactly in float64; its solve holds to JAX's megakernel as the x_init entry's does."""
    jprob, (dyn, cost, fcost, x0, u0) = problems(name)
    alphas = tsolver.ILQRConfig().alphas
    x_init = tsolver.simulate(dyn, x0, u0)
    cost_init = torch.zeros((), dtype=torch.float64)
    for t in range(u0.shape[0]):
        cost_init = cost_init + cost(x_init[t], u0[t])
    cost_init = cost_init + fcost(x_init[-1])
    ref = fused_solve.fused_ilqr_solve_kernel_plain(dyn, cost, fcost, x_init, u0, cost_init, max_iter, tol, 1e-6,
                                                    alphas)
    _build.reset_launches()
    out = fused_solve.fused_ilqr_solve_from_x0(dyn, cost, fcost, x0, u0, max_iter, tol, 1e-6, alphas)
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    x, u, k, big_k, stats = out
    jref = jsolver.ilqr_solve_fused(*jprob, jsolver.ILQRConfig(tol=tol, max_iter=max_iter))
    close_solution(jref, tsolver.ILQRSolution(x, u, stats[0, 0], int(stats[0, 1]), bool(stats[0, 2] > 0.5), k, big_k))


@pytest.mark.parametrize("name,tol,max_iter", CONFIGS)
def test_cpu_ilqr_solve_fused_is_the_host_chain_bit_for_bit(name, tol, max_iter):
    """On CPU tensors ``ilqr_solve_fused`` stays ``simulate``, ``trajectory_cost`` and the x_init entry, bit for bit."""
    _, (dyn, cost, fcost, x0, u0) = problems(name)
    config = tsolver.ILQRConfig(tol=tol, max_iter=max_iter)
    x_init = tsolver.simulate(dyn, x0, u0)
    cost_init = tsolver.trajectory_cost(cost, fcost, x_init, u0)
    x, u, k, big_k, stats = fused_solve.fused_ilqr_solve_kernel(
        dyn, cost, fcost, x_init, u0, cost_init, max_iter, tol, config.reg, config.alphas
    )
    out = tsolver.ilqr_solve_fused(dyn, cost, fcost, x0, u0, config)
    for o, r in ((out.x_seq, x), (out.u_seq, u), (out.k_seq, k), (out.big_k_seq, big_k), (out.cost, stats[0, 0])):
        assert torch.equal(o, r)
    assert out.iterations == int(stats[0, 1]) and out.converged == bool(stats[0, 2] > 0.5)


def test_zero_iteration_case_matches_jax():
    """max_iter=0: the initial rollout, zero gains, iterations 0, not converged."""
    jprob, tprob = problems("cartpole")
    ref = jsolver.ilqr_solve_fused(*jprob, jsolver.ILQRConfig(max_iter=0))
    out = tsolver.ilqr_solve_fused(*tprob, tsolver.ILQRConfig(max_iter=0))
    assert out.iterations == int(ref.iterations) == 0 and not out.converged and not bool(ref.converged)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-12)
    np.testing.assert_allclose(out.x_seq.numpy(), np.asarray(ref.x_seq), rtol=1e-12, atol=1e-14)
    assert not out.k_seq.any() and not out.big_k_seq.any()


def test_adaptive_reg_is_refused_as_in_jax():
    """Both refuse with a ValueError naming ``adaptive``; the port states its own
    reason (its kernel takes reg as an argument and carries no mu-schedule)."""
    jprob, tprob = problems("cartpole")
    with pytest.raises(ValueError, match="adaptive"):
        jsolver.ilqr_solve_fused(*jprob, jsolver.ILQRConfig(adaptive_reg=True))
    with pytest.raises(ValueError, match="adaptive.*ilqr_solve"):
        tsolver.ilqr_solve_fused(*tprob, tsolver.ILQRConfig(adaptive_reg=True))


def test_kernel_function_signature_and_stats_layout():
    """``fused_ilqr_solve_kernel`` takes the JAX arguments minus ``interpret``/``lin_block``;
    stats is (1, 3) = [cost, iterations, converged] in the trajectory's dtype."""
    _, (dyn, cost, fcost, x0, u0) = problems("cartpole")
    x_init = tsolver.simulate(dyn, x0, u0)
    cost_init = tsolver.trajectory_cost(cost, fcost, x_init, u0)
    x, u, k, big_k, stats = fused_solve.fused_ilqr_solve_kernel(
        dyn, cost, fcost, x_init, u0, cost_init, max_iter=2, tol=0.0, reg=1e-6, alphas=(1.0, 0.5, 0.25)
    )
    assert x.shape == (17, 4) and u.shape == (16, 1) and k.shape == (16, 1) and big_k.shape == (16, 1, 4)
    assert stats.shape == (1, 3) and stats.dtype == torch.float64
    assert stats[0, 1] == 2.0 and stats[0, 2] == 0.0 and stats[0, 0] < cost_init


@pytest.mark.parametrize(
    "swap,match",
    [
        (lambda p: (tsystems.make_discrete(lambda x, u: tsystems.cartpole_dynamics(x, u), 0.01), p[1], p[2]), "cartpole"),
        (lambda p: (p[0], lambda x, u: p[1](x, u), p[2]), "make_quadratic_cost"),
        (lambda p: (p[0], p[1], lambda x: p[2](x)), "make_quadratic_final_cost"),
    ],
    ids=["plant", "cost", "final-cost"],
)
def test_launch_refuses_what_the_kernel_does_not_carry(swap, match):
    """The CUDA path reads the descriptors before it builds or launches anything."""
    _, tprob = problems("cartpole")
    dyn, cost, fcost = swap(tprob)
    x_init = tsolver.simulate(tprob[0], tprob[3], tprob[4])
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        fused_solve._launch(dyn, cost, fcost, x_init, tprob[4], torch.tensor(1.0), 2, 1e-3, 1e-6, (1.0,))
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize(
    "swap,match",
    [
        (lambda p: (tsystems.make_discrete(lambda x, u: tsystems.cartpole_dynamics(x, u), 0.01), p[1], p[2], p[3]),
         "cartpole"),
        (lambda p: (p[0], lambda x, u: p[1](x, u), p[2], p[3]), "make_quadratic_cost"),
        (lambda p: (p[0], p[1], lambda x: p[2](x), p[3]), "make_quadratic_final_cost"),
        (lambda p: (p[0], p[1], p[2], tsolver.simulate(p[0], p[3], p[4])), r"expected \(4,\)"),
    ],
    ids=["plant", "cost", "final-cost", "x0-shape"],
)
def test_launch_from_x0_refuses_what_the_kernel_does_not_carry(swap, match):
    """The x0 launch reads the descriptors and the start state's shape before it builds or launches anything."""
    _, tprob = problems("cartpole")
    dyn, cost, fcost, start = swap(tprob)
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        fused_solve._launch(dyn, cost, fcost, start, tprob[4], None, 2, 1e-3, 1e-6, (1.0,))
    assert sum(_build.launches.values()) == 0
