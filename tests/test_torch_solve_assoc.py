"""Port parity: solves through the associative Riccati form, against quattro_tpu.

The bench.py problem (quadrotor RK4 hover, barrier cost), float64. Equal
iteration counts and flags; x, u and cost rtol 1e-8, gains 1e-7 on their
scale (the tolerances of the other solve tests).
"""

import jax.numpy as jnp
import numpy as np
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.solver.riccati import auto_form

RTOL = 1e-8
GAIN_TOL = 1e-7
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


def quadrotor(horizon):
    """The bench.py problem in both packages: (jax tuple, torch tuple), each (dyn, cost, fcost, x0, u0)."""
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    x0 = np.zeros(12)
    x0[2], x0[6] = 0.2, 0.1
    jprob = (jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4"),
             jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0),
             jsolver.make_quadratic_final_cost(jnp.asarray(QF), jnp.asarray(x_ref)), jnp.asarray(x0),
             jnp.zeros((horizon, 4)))
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    tprob = (tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4"),
             tsolver.make_quadratic_cost(t(Q), torch.full((4,), 0.01, dtype=torch.float64), t(x_ref),
                                         barrier_alpha=1000.0),
             tsolver.make_quadratic_final_cost(t(QF), t(x_ref)), t(x0), torch.zeros(horizon, 4, dtype=torch.float64))
    return jprob, tprob


def test_default_config_solve_matches_jax_default():
    """Both packages on ``ILQRConfig()`` (riccati="auto"): at H=50 on the CPU both take the associative form."""
    jprob, tprob = quadrotor(50)
    assert auto_form(50, 12, 4, is_cuda=False) == "assoc"
    ref = jsolver.ilqr_solve(*jprob, jsolver.ILQRConfig())
    _build.reset_launches()
    out = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig())
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert bool(out.converged) and int(out.iterations) == int(ref.iterations)
    assert bool(out.converged) == bool(ref.converged)
    for name in ("x_seq", "u_seq", "cost"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), rtol=RTOL, atol=1e-10,
                                   err_msg=name)
    for name in ("k_seq", "big_k_seq"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name).numpy(), r, rtol=0, atol=GAIN_TOL * max(np.abs(r).max(), 1.0))


def test_legacy_parallel_riccati_flag_is_the_associative_form():
    """``parallel_riccati=True`` selects the associative form, as in JAX; ``False`` the sequential one."""
    _, tprob = quadrotor(20)
    cfg = dict(tol=0.0, max_iter=2)
    assoc = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(riccati="assoc", **cfg))
    legacy = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(parallel_riccati=True, **cfg))
    seq = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(riccati="seq", **cfg))
    off = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(parallel_riccati=False, **cfg))
    for name in ("x_seq", "u_seq", "cost", "k_seq", "big_k_seq"):
        assert torch.equal(getattr(legacy, name), getattr(assoc, name)), name
        assert torch.equal(getattr(off, name), getattr(seq, name)), name
    assert not torch.equal(assoc.k_seq, seq.k_seq)  # reg sits on l_uu in one, on Q_uu in the other
