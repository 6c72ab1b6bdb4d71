"""Port parity: all-alpha rollouts and the line search against quattro_tpu.

Quadrotor RK4, H=8, A=6, inputs from a numpy seed, float64, rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.ops.fused_rollout import fused_feedback_rollouts as j_fused_rollouts
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build, contract, fused_rollout

H = 8
RTOL = 1e-10
ATOL = 1e-12
ALPHAS = np.array([1.0, 0.5, 0.25, 0.1, 0.05, 0.01])
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]


def rollout_inputs(seed=3, horizon=H):
    rng = np.random.default_rng(seed)
    x0 = 0.1 * rng.standard_normal(12)
    x_ref = 0.1 * rng.standard_normal((horizon + 1, 12))
    u_ref = 2.4525 + 0.1 * rng.standard_normal((horizon, 4))
    k = 0.05 * rng.standard_normal((horizon, 4))
    big_k = 0.05 * rng.standard_normal((horizon, 4, 12))
    return x0, x_ref, u_ref, k, big_k, ALPHAS.copy()


def _close(ref, out):
    np.testing.assert_allclose(out.cpu().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_plain_k2_matches_jax_fused_kernel(method):
    inputs = rollout_inputs()
    jdyn = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, method)
    tdyn = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, method)
    ref_x, ref_u = j_fused_rollouts(jdyn, *(jnp.asarray(v) for v in inputs), interpret=True)
    cand_x, cand_u = fused_rollout.fused_feedback_rollouts(tdyn, *(torch.from_numpy(v) for v in inputs))
    assert cand_x.shape == (6, H + 1, 12) and cand_u.shape == (6, H, 4)
    _close(ref_x, cand_x)
    _close(ref_u, cand_u)


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_plain_k2_cartpole_matches_jax_fused_kernel(method):
    rng = np.random.default_rng(6)
    horizon = 10
    inputs = (0.1 * rng.standard_normal(4), 0.1 * rng.standard_normal((horizon + 1, 4)),
              0.5 * rng.standard_normal((horizon, 1)), 0.5 * rng.standard_normal((horizon, 1)),
              0.5 * rng.standard_normal((horizon, 1, 4)), ALPHAS.copy())
    jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, method)
    tdyn = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, method)
    ref_x, ref_u = j_fused_rollouts(jdyn, *(jnp.asarray(v) for v in inputs), interpret=True)
    cand_x, cand_u = fused_rollout.fused_feedback_rollouts(tdyn, *(torch.from_numpy(v) for v in inputs))
    assert cand_x.shape == (6, horizon + 1, 4) and cand_u.shape == (6, horizon, 1)
    _close(ref_x, cand_x)
    _close(ref_u, cand_u)


def test_device_plant_descriptor_for_both_plants():
    """What the kernels' C entry points get: plant id, parameters in order, integrator, dt."""
    quad = tsystems.make_discrete(tsystems.QuadrotorField(tsystems.QuadrotorParams(mass=1.3)), 0.02, "euler")
    pid, params, rk4, dt = contract.device_plant(quad, "test", 12, 4)
    assert (pid, rk4, dt) == (0, 0, 0.02) and list(params) == [1.3, 0.02, 0.02, 0.04, 0.1, 9.81, 0.01]
    cart = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4")
    pid, params, rk4, dt = contract.device_plant(cart, "test", 4, 1)
    assert (pid, rk4, dt) == (1, 1, 0.01) and list(params) == [1.0, 0.1, 0.15, 9.81]
    with pytest.raises(ValueError, match="n=4, m=1"):
        contract.device_plant(cart, "test", 12, 4)


def _problem():
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    jdyn = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4")
    jc = jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0)
    jf = jsolver.make_quadratic_final_cost(10.0 * jnp.asarray(Q), jnp.asarray(x_ref))
    q = torch.tensor(Q, dtype=torch.float64)
    tdyn = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4")
    tc = tsolver.make_quadratic_cost(q, torch.full((4,), 0.01, dtype=torch.float64), torch.from_numpy(x_ref), barrier_alpha=1000.0)
    tf = tsolver.make_quadratic_final_cost(10.0 * q, torch.from_numpy(x_ref))
    return (jdyn, jc, jf), (tdyn, tc, tf)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("current_cost", [1e9, 1e-9])
def test_line_search_matches_jax(fused, current_cost):
    """current_cost 1e-9 accepts no candidate: the reference comes back unchanged."""
    x0, x_ref, u_ref, k, big_k, alphas = rollout_inputs(seed=4)
    jprob, tprob = _problem()
    jls = jsolver.line_search_fused if fused else jsolver.line_search
    tls = tsolver.line_search_fused if fused else tsolver.line_search
    jargs = [jnp.asarray(v) for v in (x0, x_ref, u_ref, k, big_k)] + [jnp.asarray(current_cost), jnp.asarray(alphas)]
    targs = [torch.from_numpy(v) for v in (x0, x_ref, u_ref, k, big_k)] + [torch.tensor(current_cost, dtype=torch.float64), torch.from_numpy(alphas)]
    ref = jls(*jprob, *jargs)
    out = tls(*tprob, *targs)
    assert bool(out[0]) == bool(ref[0]) == (current_cost > 1.0)
    for r, o in zip(ref, out):
        _close(r, o)


def test_line_search_fuse_cost_matches_jax():
    x0, x_ref, u_ref, k, big_k, alphas = rollout_inputs(seed=5)
    jprob, tprob = _problem()
    ref = jsolver.line_search(*jprob, *(jnp.asarray(v) for v in (x0, x_ref, u_ref, k, big_k)), jnp.asarray(1e9), jnp.asarray(alphas), fuse_cost=True)
    out = tsolver.line_search(*tprob, *(torch.from_numpy(v) for v in (x0, x_ref, u_ref, k, big_k)), torch.tensor(1e9, dtype=torch.float64), torch.from_numpy(alphas), fuse_cost=True)
    for r, o in zip(ref, out):
        _close(r, o)


def test_k2_refuses_unknown_plant_before_launch():
    """The CUDA path reads the plant descriptor first; a lambda has none."""
    inputs = [torch.from_numpy(v) for v in rollout_inputs()]
    lam = tsystems.make_discrete(lambda x, u: tsystems.quadrotor_dynamics(x, u), 0.01, "rk4")
    _build.reset_launches()
    with pytest.raises(ValueError, match="quadrotor"):
        fused_rollout._launch(lam, *inputs)
    assert sum(_build.launches.values()) == 0

