"""Port parity: the batched solve's "vmap" backend with the associative Riccati form.

With ``riccati="assoc"`` the port runs the associative form batched over the
(B, H) stage tensors (two K8 launches per trip on the card) where JAX runs
``vmap`` of the per-lane form. The JAX tests' cart-pole batch (B=4, H=20,
float64, initial states from a numpy seed): equal iterations and flags, x, u
and cost rtol 1e-8 against JAX; each lane equal to the port's single solve of
that lane (rtol 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import parallel as jparallel
from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.parallel import batched_ilqr_solve

RTOL = 1e-8


def cartpole_batch(horizon, seed, batch=4):
    x0s = 0.3 * np.random.default_rng(seed).standard_normal((batch, 4))
    q, r, qf = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
    j = (jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4"),
         jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jnp.zeros(4)),
         jsolver.make_quadratic_final_cost(jnp.asarray(qf), jnp.zeros(4)), jnp.asarray(x0s),
         jnp.zeros((batch, horizon, 1)))
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    tp = (tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
          tsolver.make_quadratic_cost(t(q), t(r), t([0.0] * 4)),
          tsolver.make_quadratic_final_cost(t(qf), t([0.0] * 4)), t(x0s),
          torch.zeros(batch, horizon, 1, dtype=torch.float64))
    return j, tp


@pytest.mark.parametrize("options", [dict(tol=1e-1, max_iter=8), dict(tol=1e-2, max_iter=6, adaptive_reg=True, reg=1e-3)],
                         ids=["static-reg", "adaptive-reg"])
def test_batched_vmap_assoc_matches_jax_and_a_lane_loop(options):
    jprob, tprob = cartpole_batch(20, seed=11)
    cfg = dict(riccati="assoc", **options)
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**cfg), riccati_backend="vmap")
    _build.reset_launches()
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend="vmap")
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for name in ("x_seq", "u_seq", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=RTOL,
                                   atol=1e-10, err_msg=name)
    for lane in range(4):
        single = tsolver.ilqr_solve(*tprob[:3], tprob[3][lane], tprob[4][lane], tsolver.ILQRConfig(**cfg))
        assert int(got.iterations[lane]) == single.iterations and bool(got.converged[lane]) == single.converged
        np.testing.assert_allclose(got.u_seq[lane].numpy(), single.u_seq.numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(got.cost[lane]), float(single.cost), rtol=1e-10)


def test_auto_on_cpu_for_one_trajectory_takes_the_batched_associative_form():
    """B=1 at H >= 16: "auto" resolves as for one lane (JAX's vmap of riccati_backward_auto takes its
    associative branch there), so the batch of one equals the single default solve."""
    _, tprob = cartpole_batch(20, seed=3, batch=1)
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(tol=1e-1, max_iter=6))
    single = tsolver.ilqr_solve(*tprob[:3], tprob[3][0], tprob[4][0], tsolver.ILQRConfig(tol=1e-1, max_iter=6))
    assoc = tsolver.ilqr_solve(*tprob[:3], tprob[3][0], tprob[4][0], tsolver.ILQRConfig(tol=1e-1, max_iter=6,
                                                                                        riccati="assoc"))
    assert int(got.iterations[0]) == single.iterations
    np.testing.assert_allclose(got.u_seq[0].numpy(), single.u_seq.numpy(), rtol=1e-10, atol=1e-12)
    assert torch.equal(single.u_seq, assoc.u_seq)
