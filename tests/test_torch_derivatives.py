"""Port parity: linearization and cost quadratization against quattro_tpu.

A quadrotor and a cart-pole trajectory of H=8 steps from a numpy seed, float64,
rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems

H = 8
RTOL = 1e-10
ATOL = 1e-12
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]


def _trajectory():
    rng = np.random.default_rng(11)
    x_seq = 0.2 * rng.standard_normal((H + 1, 12))
    u_seq = 2.45 + 0.3 * rng.standard_normal((H, 4))
    u_seq[2, 1] = -0.1  # one rotor inside the barrier
    u_seq[4, 3] = 0.0  # one exactly at its kink
    return x_seq, u_seq


def _close(ref, out):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_linearize_dynamics_matches_jax():
    x_seq, u_seq = _trajectory()
    ja, jb = jsolver.linearize_dynamics(
        jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4"), jnp.asarray(x_seq), jnp.asarray(u_seq)
    )
    ta, tb = tsolver.linearize_dynamics(
        tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4"), torch.from_numpy(x_seq), torch.from_numpy(u_seq)
    )
    assert ta.shape == (H, 12, 12) and tb.shape == (H, 12, 4)
    _close(ja, ta)
    _close(jb, tb)


def test_quadratize_cost_and_final_cost_match_jax():
    x_seq, u_seq = _trajectory()
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    jc = jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0)
    jf = jsolver.make_quadratic_final_cost(10.0 * jnp.asarray(Q), jnp.asarray(x_ref))
    q = torch.tensor(Q, dtype=torch.float64)
    tx = torch.from_numpy(x_ref)
    tc = tsolver.make_quadratic_cost(q, torch.full((4,), 0.01, dtype=torch.float64), tx, barrier_alpha=1000.0)
    tf = tsolver.make_quadratic_final_cost(10.0 * q, tx)

    jexp = jsolver.quadratize_cost(jc, jnp.asarray(x_seq), jnp.asarray(u_seq))
    texp = tsolver.quadratize_cost(tc, torch.from_numpy(x_seq), torch.from_numpy(u_seq))
    assert texp._fields == jexp._fields
    for ref, out in zip(jexp, texp):
        _close(ref, out)

    jfin = jsolver.quadratize_final_cost(jf, jnp.asarray(x_seq[-1]))
    tfin = tsolver.quadratize_final_cost(tf, torch.from_numpy(x_seq[-1]))
    assert tfin._fields == jfin._fields
    for ref, out in zip(jfin, tfin):
        _close(ref, out)


def test_cartpole_linearize_and_quadratize_match_jax():
    rng = np.random.default_rng(12)
    x_seq = np.array([0.3, 0.5, 0.6, 1.5]) * rng.standard_normal((H + 1, 4))
    u_seq = 5.0 * rng.standard_normal((H, 1))
    ja, jb = jsolver.linearize_dynamics(
        jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4"), jnp.asarray(x_seq), jnp.asarray(u_seq)
    )
    ta, tb = tsolver.linearize_dynamics(
        tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"), torch.from_numpy(x_seq), torch.from_numpy(u_seq)
    )
    assert ta.shape == (H, 4, 4) and tb.shape == (H, 4, 1)
    _close(ja, ta)
    _close(jb, tb)

    q, r = [5.0, 0.1, 10.0, 0.1], [0.001]
    jc = jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jnp.zeros(4))
    tc = tsolver.make_quadratic_cost(torch.tensor(q, dtype=torch.float64), torch.tensor(r, dtype=torch.float64),
                                     torch.zeros(4, dtype=torch.float64))
    for ref, out in zip(jsolver.quadratize_cost(jc, jnp.asarray(x_seq), jnp.asarray(u_seq)),
                        tsolver.quadratize_cost(tc, torch.from_numpy(x_seq), torch.from_numpy(u_seq))):
        _close(ref, out)
