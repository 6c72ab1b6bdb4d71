"""Port parity: quadrotor and cart-pole vector fields, integrators and costs against quattro_tpu.

Inputs come from a numpy seed and go through both packages in float64;
tolerance rtol 1e-12 (same formulas, same operation order up to reductions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems

RTOL = 1e-12
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]


def _state_control(seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal(12)
    u = 2.45 + 0.5 * rng.standard_normal(4)
    return x, u


def _close(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quadrotor_field_matches_jax(seed):
    x, u = _state_control(seed)
    params = tsystems.QuadrotorParams(mass=1.3, arm=0.12)
    ref = jsystems.quadrotor_dynamics(jnp.asarray(x), jnp.asarray(u), jsystems.QuadrotorParams(*params))
    out = tsystems.QuadrotorField(params)(torch.from_numpy(x), torch.from_numpy(u))
    _close(ref, out.numpy(), atol=1e-14)


def test_quadrotor_field_broadcasts_over_batch():
    xs, us = zip(*[_state_control(s) for s in range(5)])
    xb, ub = torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(us))
    batched = tsystems.quadrotor_dynamics(xb, ub)
    rows = torch.stack([tsystems.quadrotor_dynamics(x, u) for x, u in zip(xb, ub)])
    np.testing.assert_array_equal(batched.numpy(), rows.numpy())


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_discrete_steps_match_jax(method):
    x, u = _state_control(3)
    jdyn = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, method)
    tdyn = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, method)
    assert tdyn.plant == "quadrotor" and tdyn.method == method
    _close(jdyn(jnp.asarray(x), jnp.asarray(u)), tdyn(torch.from_numpy(x), torch.from_numpy(u)).numpy())


def _cartpole_state_control(seed):
    rng = np.random.default_rng(seed)
    return np.array([0.3, 0.5, 0.6, 1.5]) * rng.standard_normal(4), 5.0 * rng.standard_normal(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cartpole_field_matches_jax(seed):
    x, u = _cartpole_state_control(seed)
    params = tsystems.CartPoleParams(m_cart=1.2, length=0.2)
    ref = jsystems.cartpole_dynamics(jnp.asarray(x), jnp.asarray(u), jsystems.CartPoleParams(*params))
    out = tsystems.CartPoleField(params)(torch.from_numpy(x), torch.from_numpy(u))
    _close(ref, out.numpy(), atol=1e-14)


def test_cartpole_field_broadcasts_over_batch():
    xs, us = zip(*[_cartpole_state_control(s) for s in range(5)])
    xb, ub = torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(us))
    batched = tsystems.cartpole_dynamics(xb, ub)
    rows = torch.stack([tsystems.cartpole_dynamics(x, u) for x, u in zip(xb, ub)])
    np.testing.assert_array_equal(batched.numpy(), rows.numpy())


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_cartpole_discrete_steps_match_jax(method):
    x, u = _cartpole_state_control(3)
    jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, method)
    tdyn = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, method)
    assert tdyn.plant == "cartpole" and tuple(tdyn.params) == tuple(jsystems.CartPoleParams())
    _close(jdyn(jnp.asarray(x), jnp.asarray(u)), tdyn(torch.from_numpy(x), torch.from_numpy(u)).numpy())


def test_cartpole_linearized_matches_jax_and_is_the_simplified_form():
    params = tsystems.CartPoleParams(m_pole=0.2)
    ja, jb = jsystems.cartpole_linearized(jsystems.CartPoleParams(*params))
    ta, tb = tsystems.cartpole_linearized(params, device="cpu", dtype=torch.float64)
    _close(ja, ta.numpy())
    _close(jb, tb.numpy())
    # Kept as it is: it drops the 4/3 factor, so it is not the field's Jacobian at the origin.
    jac = jacfwd(lambda x: tsystems.cartpole_dynamics(x, torch.zeros(1, dtype=torch.float64), params))(
        torch.zeros(4, dtype=torch.float64))
    assert not np.allclose(jac.numpy(), ta.numpy(), rtol=1e-3)


def test_make_discrete_rejects_unknown_method():
    with pytest.raises(ValueError):
        tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "verlet")
    assert tsystems.make_discrete(lambda x, u: x, 0.01).plant is None


def test_hover_control_needs_explicit_cpu():
    u = tsystems.hover_control(device="cpu", dtype=torch.float64)
    _close(jsystems.hover_control(), u.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsystems.hover_control()


def _costs(x_ref):
    jc = jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0)
    jf = jsolver.make_quadratic_final_cost(10.0 * jnp.asarray(Q), jnp.asarray(x_ref))
    tx = torch.from_numpy(x_ref)
    tc = tsolver.make_quadratic_cost(torch.tensor(Q, dtype=torch.float64), torch.full((4,), 0.01, dtype=torch.float64), tx, barrier_alpha=1000.0)
    tf = tsolver.make_quadratic_final_cost(10.0 * torch.tensor(Q, dtype=torch.float64), tx)
    return jc, jf, tc, tf


@pytest.mark.parametrize("seed", [0, 1])
def test_quadratic_costs_match_jax(seed):
    x, u = _state_control(seed)
    u[1] = -0.05  # barrier active on one rotor
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    jc, jf, tc, tf = _costs(x_ref)
    _close(jc(jnp.asarray(x), jnp.asarray(u)), tc(torch.from_numpy(x), torch.from_numpy(u)).numpy())
    _close(jf(jnp.asarray(x)), tf(torch.from_numpy(x)).numpy())


def test_cost_objects_carry_their_tables():
    """What the whole-solve kernel's wrapper reads: full matrices, reference, barrier, kind."""
    x_ref = torch.zeros(4, dtype=torch.float64)
    full = torch.tensor([[2.0, 0.5], [0.1, 3.0]], dtype=torch.float64)
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    cost = tsolver.make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), full, x_ref, barrier_alpha=3.0, barrier_beta=7.0)
    fcost = tsolver.make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), x_ref)
    assert (cost.kind, fcost.kind) == ("quadratic", "quadratic_final")
    assert cost.q_mat.shape == (4, 4) and cost.q_mat.dtype == torch.float64 and cost.q_mat[2, 2] == 10.0
    assert torch.equal(cost.r_mat, full) and cost.x_ref is x_ref and fcost.x_ref is x_ref
    assert (cost.barrier_alpha, cost.barrier_beta) == (3.0, 7.0) and fcost.qf_mat[0, 0] == 50.0
    # torch.func.vmap names a callable object by its repr on every call: no tensor is printed.
    assert repr(cost) == "QuadraticCost(n=4, m=2, barrier_alpha=3.0, barrier_beta=7.0)"
    assert repr(fcost) == "QuadraticFinalCost(n=4)"
    # A full, non-symmetric R: the value is u'R u as JAX computes it.
    u = np.array([0.3, -0.2])
    jc = jsolver.make_quadratic_cost(jnp.asarray([5.0, 0.1, 10.0, 0.1]), jnp.asarray(full.numpy()), jnp.zeros(4),
                                     barrier_alpha=3.0, barrier_beta=7.0)
    _close(jc(jnp.ones(4), jnp.asarray(u)), cost(torch.ones(4, dtype=torch.float64), torch.from_numpy(u)).numpy())


@pytest.mark.parametrize("u0", [0.0, -0.3, 0.2, 80.0, -80.0])
def test_barrier_grad_and_hessian_match_jax(u0):
    """Includes u = 0 exactly (where a solve from zero controls starts) and
    both saturated ends, where a naive max/abs form would differ."""
    u = np.array([u0, 0.1, -0.02, 0.0])
    jf = lambda v: jsolver.softplus_barrier(v, 10.0)
    tf = lambda v: tsolver.softplus_barrier(v, 10.0)
    tu = torch.from_numpy(u)
    _close(jf(jnp.asarray(u)), tf(tu).numpy())
    _close(jax.grad(jf)(jnp.asarray(u)), grad(tf)(tu).numpy(), atol=1e-300)
    _close(jax.hessian(jf)(jnp.asarray(u)), jacfwd(grad(tf))(tu).numpy(), atol=1e-300)
