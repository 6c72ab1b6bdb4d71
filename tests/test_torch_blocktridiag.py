"""Port parity: ops/blocktridiag.py (the trajectory KKT route, kernel K9's plain form) against quattro_tpu.

K9's plain form ``btd_matvec_plain`` is held to JAX's kernel
``btd_matvec_pallas`` run in interpret mode and to JAX's ``btd_matvec``;
every function of the module (``build_lqr_kkt``, ``btd_solve``,
``recover_primal``, ``kkt_residual``) to JAX's on the LQ subproblems of the
cart-pole (H=30, the problem of ``tests/test_ops.py``) and the quadrotor (the
bench.py problem at H=12), linearized by JAX about a rollout of seeded
controls and handed to both packages as numpy arrays. float64, rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.ops import blocktridiag as jbtd
from quattro_tpu.solver.derivatives import CostExpansion as JCostExpansion
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.ops import blocktridiag as btd
from quattro_tpu_torch.solver import CostExpansion, riccati_backward

RTOL = 1e-10
ATOL = 1e-12


def random_btd(num_blocks, n, seed):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((num_blocks, n, n))
    diag = diag @ np.swapaxes(diag, -1, -2) + 3.0 * np.eye(n)
    lower = 0.1 * rng.standard_normal((num_blocks - 1, n, n))
    return diag, lower, rng.standard_normal((num_blocks, n))


def close(out, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("num_blocks, n", [(32, 8), (5, 12), (1, 4)])
def test_k9_plain_matches_jax_pallas_kernel_and_btd_matvec(num_blocks, n):
    diag, lower, x = random_btd(num_blocks, n, seed=num_blocks)
    jmat = jbtd.BlockTridiagonal(jnp.asarray(diag), jnp.asarray(lower))
    mat = btd.BlockTridiagonal(torch.from_numpy(diag), torch.from_numpy(lower))
    out = btd.btd_matvec_plain(mat, torch.from_numpy(x))
    close(out, jbtd.btd_matvec_pallas(jmat, jnp.asarray(x), interpret=True))
    close(out, jbtd.btd_matvec(jmat, jnp.asarray(x)))
    _build.reset_launches()
    assert torch.equal(btd.btd_matvec(mat, torch.from_numpy(x)), out)  # the plain form on CPU tensors
    assert torch.equal(btd.btd_matvec_fused(mat, torch.from_numpy(x)), out)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("num_blocks", [1, 2])
@pytest.mark.parametrize("n", [4, 12])
def test_btd_matvec_and_kkt_residual_at_the_shortest_systems_match_jax(num_blocks, n):
    """N = 1 (no band) and N = 2 (one L, read as L and L^T): btd_matvec and kkt_residual against JAX's."""
    diag, lower, x = random_btd(num_blocks, n, seed=10 * num_blocks + n)
    rhs = np.random.default_rng(n).standard_normal((num_blocks, n))
    jmat = jbtd.BlockTridiagonal(jnp.asarray(diag), jnp.asarray(lower))
    mat = btd.BlockTridiagonal(torch.from_numpy(diag), torch.from_numpy(lower))
    close(btd.btd_matvec(mat, torch.from_numpy(x)), jbtd.btd_matvec(jmat, jnp.asarray(x)))
    res = btd.kkt_residual(mat, torch.from_numpy(x), torch.from_numpy(rhs))
    assert res.shape == (num_blocks,)
    close(res, jbtd.kkt_residual(jmat, jnp.asarray(x), jnp.asarray(rhs)))


def test_block_nnz_and_num_blocks():
    diag, lower, _ = random_btd(10, 3, seed=4)
    mat = btd.BlockTridiagonal(torch.from_numpy(diag), torch.from_numpy(lower))
    assert mat.num_blocks == 10 and mat.block_nnz == 10 + 2 * 9
    assert mat.block_nnz == jbtd.BlockTridiagonal(jnp.asarray(diag), jnp.asarray(lower)).block_nnz


def test_k9_refuses_mismatched_shapes_before_launch():
    diag, lower, x = random_btd(4, 3, seed=5)
    mat = btd.BlockTridiagonal(torch.from_numpy(diag), torch.from_numpy(lower[:2]))
    _build.reset_launches()
    with pytest.raises(ValueError, match="expected"):
        btd._launch(mat, torch.from_numpy(x))
    with pytest.raises(ValueError, match="float32 or float64"):
        btd._launch(btd.BlockTridiagonal(*(torch.from_numpy(v).half() for v in (diag, lower))),
                    torch.from_numpy(x).half())
    assert sum(_build.launches.values()) == 0


Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


def lq_subproblem(plant):
    """(a, b, exp fields, v_x, v_xx) as numpy arrays: JAX's linearization about a JAX rollout."""
    rng = np.random.default_rng(3)
    if plant == "cartpole":
        dyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
        cost = jsolver.make_quadratic_cost(jnp.array([5.0, 0.1, 10.0, 0.1]), jnp.array([0.001]), jnp.zeros(4))
        fcost = jsolver.make_quadratic_final_cost(jnp.array([50.0, 6.0, 100.0, 0.1]), jnp.zeros(4))
        x0, u = jnp.array([0.2, 0.0, 0.3, 0.0]), jnp.asarray(0.5 * rng.standard_normal((30, 1)))
    else:
        x_ref = jnp.zeros(12).at[2].set(0.5)
        dyn = jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4")
        cost = jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), x_ref, barrier_alpha=1000.0)
        fcost = jsolver.make_quadratic_final_cost(jnp.asarray(QF), x_ref)
        x0 = jnp.zeros(12).at[2].set(0.2).at[6].set(0.1)
        u = jnp.asarray(2.4525 + 0.1 * rng.standard_normal((12, 4)))
    x = jsolver.simulate(dyn, x0, u)
    a, b = jsolver.linearize_dynamics(dyn, x, u)
    exp = jsolver.quadratize_cost(cost, x, u)
    fexp = jsolver.quadratize_final_cost(fcost, x[-1])
    return tuple(np.asarray(v) for v in (a, b, *exp, fexp.v_x, fexp.v_xx))


@pytest.fixture(scope="module", params=["cartpole", "quadrotor"])
def subproblem(request):
    return lq_subproblem(request.param)


def both(arrays):
    a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx = arrays
    t, j = torch.from_numpy, jnp.asarray
    tor = (t(a), t(b), CostExpansion(t(l_x), t(l_u), t(l_xx), t(l_uu), t(l_ux)), t(v_x), t(v_xx))
    jax_ = (j(a), j(b), JCostExpansion(j(l_x), j(l_u), j(l_xx), j(l_uu), j(l_ux)), j(v_x), j(v_xx))
    return tor, jax_


@pytest.mark.parametrize("reg", [1e-6, 1e-9])
def test_kkt_route_matches_jax(subproblem, reg):
    """build_lqr_kkt -> btd_solve -> recover_primal -> kkt_residual, each output against JAX's."""
    tor, jax_ = both(subproblem)
    system = btd.build_lqr_kkt(*tor, reg=reg)
    jsystem = jbtd.build_lqr_kkt(*jax_, reg=reg)
    for name in ("rhs", "z_seq", "a_til", "ltil_x"):
        close(getattr(system, name), getattr(jsystem, name))
    close(system.matrix.diag, jsystem.matrix.diag)
    close(system.matrix.lower, jsystem.matrix.lower)
    _build.reset_launches()
    lam = btd.btd_solve(system.matrix, system.rhs)
    jlam = jbtd.btd_solve(jsystem.matrix, jsystem.rhs)
    close(lam, jlam, rtol=1e-9, atol=1e-11)
    close(btd.recover_primal(system, lam), jbtd.recover_primal(jsystem, jlam), rtol=1e-9, atol=1e-11)
    res = btd.kkt_residual(system.matrix, lam, system.rhs)
    assert sum(_build.launches.values()) == 0
    assert res.shape == (system.rhs.shape[0],)
    assert float(res.max()) < 1e-8 * max(float(system.rhs.abs().max()), 1.0)
    # The residual of the same (port) solution through JAX's SpMV.
    jres = jbtd.kkt_residual(jsystem.matrix, jnp.asarray(lam.numpy()), jsystem.rhs)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0, atol=1e-12 * float(system.rhs.abs().max()))


def test_kkt_route_is_spd_and_equals_the_riccati_newton_step(subproblem):
    """``tests/test_ops.py``'s checks on the port: the dual Schur system is SPD, and dx from the
    multipliers equals the Riccati gains rolled through the linearized dynamics (rtol 1e-5, atol 1e-8)."""
    tor, _ = both(subproblem)
    a, b, exp, v_x, v_xx = tor
    system = btd.build_lqr_kkt(*tor, reg=1e-9)
    num_blocks, n, _ = system.matrix.diag.shape
    dense = torch.zeros(num_blocks * n, num_blocks * n, dtype=torch.float64)
    for t in range(num_blocks):
        dense[t * n:(t + 1) * n, t * n:(t + 1) * n] = system.matrix.diag[t]
    for t in range(num_blocks - 1):
        dense[(t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = system.matrix.lower[t]
        dense[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = system.matrix.lower[t].T
    assert float(torch.linalg.eigvalsh(dense).min()) > 0
    lam = btd.btd_solve(system.matrix, system.rhs)
    np.testing.assert_allclose(lam.numpy().ravel(), np.linalg.solve(dense.numpy(), system.rhs.numpy().ravel()),
                               rtol=1e-8, atol=1e-10)
    dx_kkt = btd.recover_primal(system, lam)
    res = riccati_backward(a, b, exp, v_x, v_xx, reg=1e-9)
    dx, dx_riccati = torch.zeros(n, dtype=torch.float64), []
    for t in range(a.shape[0]):
        dx = a[t] @ dx + b[t] @ (res.k_seq[t] + res.big_k_seq[t] @ dx)
        dx_riccati.append(dx)
    np.testing.assert_allclose(dx_kkt.numpy(), torch.stack(dx_riccati).numpy(), rtol=1e-5, atol=1e-8)
