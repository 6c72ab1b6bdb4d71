"""Port parity: batched all-alpha rollouts (K6/K7's plain form) and the batched
line searches against quattro_tpu.

JAX's ``fused_feedback_rollouts_batched`` (K7) and ``..._batched2d`` (K6)
run in interpret mode at the shapes of ``tests/test_fused_rollout.py``
(quadrotor RK4, B=5, H=13: batch and horizon padding on the TPU side), as do
``line_search_batched_fused`` and ``line_search_batched2d``. Inputs from a
numpy seed, float64, rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.ops import fused_rollout as jfro
from quattro_tpu.solver import rollout as jrollout
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build, fused_rollout

RTOL = 1e-10
ATOL = 1e-12
ALPHAS = np.array([1.0, 0.5, 0.25, 0.1, 0.05, 0.01])
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]


def inputs(batch=5, horizon=13, seed=3):
    rng = np.random.default_rng(seed)
    return (
        0.1 * rng.standard_normal((batch, 12)),
        0.1 * rng.standard_normal((batch, horizon + 1, 12)),
        2.4525 + 0.1 * rng.standard_normal((batch, horizon, 4)),
        0.05 * rng.standard_normal((batch, horizon, 4)),
        0.05 * rng.standard_normal((batch, horizon, 4, 12)),
    )


def close(ref, out):
    for r, o in zip(ref, out):
        assert tuple(o.shape) == tuple(np.shape(r))
        np.testing.assert_allclose(np.asarray(o.numpy(), dtype=np.float64), np.asarray(r, dtype=np.float64),
                                   rtol=RTOL, atol=ATOL)


JDYN = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4")
TDYN = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4")


@pytest.mark.parametrize("entry", ["batched", "batched2d"])
def test_batched_rollouts_match_jax(entry):
    data = inputs()
    jargs = [jnp.asarray(v) for v in data] + [jnp.asarray(ALPHAS)]
    targs = [torch.from_numpy(v) for v in data] + [torch.from_numpy(ALPHAS)]
    if entry == "batched":
        ref = jfro.fused_feedback_rollouts_batched(JDYN, *jargs, interpret=True)
    else:
        ref = jfro.fused_feedback_rollouts_batched2d(JDYN, *jargs, interpret=True, tile_s=1, block_t=4,
                                                     max_resident=2)
    _build.reset_launches()
    out = getattr(fused_rollout, f"fused_feedback_rollouts_{entry}")(TDYN, *targs)
    assert sum(_build.launches.values()) == 0  # CPU tensors take the plain form
    assert out[0].shape == (6, 5, 14, 12) and out[1].shape == (6, 5, 13, 4)
    close(ref, out)


def costs(goal_z):
    x_goal = np.zeros(12)
    x_goal[2] = goal_z
    j = (jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_goal), barrier_alpha=1000.0),
         jsolver.make_quadratic_final_cost(10 * jnp.asarray(Q), jnp.asarray(x_goal)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    tp = (tsolver.make_quadratic_cost(t(Q), t([0.01] * 4), t(x_goal), barrier_alpha=1000.0),
          tsolver.make_quadratic_final_cost(10 * t(Q), t(x_goal)))
    return j, tp


@pytest.mark.parametrize("entry", ["batched_fused", "batched2d"])
def test_batched_line_searches_match_jax(entry):
    """Mixed accepts: lane 0 accepts at any cost, the others at realistic ones (some find none)."""
    x0, x_ref, u_ref, k, big_k = inputs(batch=4, horizon=11, seed=2)
    current = np.array([1e9, 50.0, 120.0, 80.0])
    (jcost, jfcost), (tcost, tfcost) = costs(0.5)
    jargs = [jnp.asarray(v) for v in (x0, x_ref, u_ref, k, big_k, current, ALPHAS)]
    targs = [torch.from_numpy(v) for v in (x0, x_ref, u_ref, k, big_k, current, ALPHAS)]
    ref = getattr(jrollout, f"line_search_{entry}")(JDYN, jcost, jfcost, *jargs, interpret=True)
    got = getattr(tsolver, f"line_search_{entry}")(TDYN, tcost, tfcost, *targs)
    assert [bool(f) for f in got[0]] == [bool(f) for f in np.asarray(ref[0])]
    close(ref, got)


def test_batched_line_search_matches_vmapped_line_search():
    """The batched select is ``line_search`` per trajectory."""
    x0, x_ref, u_ref, k, big_k = (torch.from_numpy(v) for v in inputs(batch=3, horizon=9, seed=4))
    _, (tcost, tfcost) = costs(0.0)
    xs = torch.stack([tsolver.simulate(TDYN, x, u) for x, u in zip(x0, u_ref)])
    c0 = torch.stack([tsolver.trajectory_cost(tcost, tfcost, x, u) for x, u in zip(xs, u_ref)])
    alphas = torch.from_numpy(ALPHAS)
    got = tsolver.line_search_batched2d(TDYN, tcost, tfcost, x0, xs, u_ref, k, big_k, c0, alphas)
    for lane in range(3):
        ref = tsolver.line_search(TDYN, tcost, tfcost, x0[lane], xs[lane], u_ref[lane], k[lane], big_k[lane],
                                  c0[lane], alphas)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g[lane].numpy(), r.numpy(), rtol=RTOL, atol=ATOL)
