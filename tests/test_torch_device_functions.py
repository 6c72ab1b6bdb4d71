"""The kernels' hand-written derivatives, built for the host, against quattro_tpu's autodiff.

``csrc/plants.cuh`` (dual-number Jacobians of the Euler / RK4 step) and
``csrc/costs.cuh`` (analytic expansion of the quadratic + softplus^2-barrier
cost) are host-and-device code. ``csrc/host_derivatives.cpp`` wraps them in a
plain C interface, which ``ops/_build.py`` builds here with the host C++
compiler. This is the check of those derivatives that runs without a GPU:
seeded float64 points through the library and through
``quattro_tpu.solver.linearize_dynamics`` / ``quadratize_cost`` /
``quadratize_final_cost``, rtol 1e-10 (two derivations of the same
derivatives, each exact up to rounding), including controls at 0 and below 0
for the barrier. Skips where no C++ compiler is found.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch.ops import _build

RTOL = 1e-10
ATOL = 1e-12
DOUBLE_P = ctypes.POINTER(ctypes.c_double)
PLANTS = {
    "quadrotor": dict(id=0, n=12, m=4, field=jsystems.quadrotor_dynamics,
                      params=jsystems.QuadrotorParams(mass=1.3, arm=0.12)),
    "cartpole": dict(id=1, n=4, m=1, field=jsystems.cartpole_dynamics,
                     params=jsystems.CartPoleParams(m_pole=0.2, length=0.2)),
}


@pytest.fixture(scope="module")
def lib():
    if not any(shutil.which(cc) for cc in ("c++", "g++", "clang++")) or shutil.which("ninja") is None:
        pytest.skip("needs a host C++ compiler and ninja to build csrc/host_derivatives.cpp")
    library = _build.library("host_derivatives")
    library.qt_host_step_and_jacobian.restype = ctypes.c_int
    library.qt_host_step_and_jacobian.argtypes = (
        [ctypes.c_int, DOUBLE_P, ctypes.c_int, ctypes.c_double] + [DOUBLE_P] * 5
    )
    library.qt_host_cost_and_expansion.restype = ctypes.c_int
    library.qt_host_cost_and_expansion.argtypes = (
        [ctypes.c_int] + [DOUBLE_P] * 3 + [ctypes.c_double] * 2 + [DOUBLE_P] * 12
    )
    return library


def ptr(array):
    assert array.dtype == np.float64 and array.flags.c_contiguous
    return array.ctypes.data_as(DOUBLE_P)


def points(name, seed):
    rng = np.random.default_rng(seed)
    if name == "quadrotor":
        return 0.3 * rng.standard_normal(12), 2.45 + 0.5 * rng.standard_normal(4)
    return np.array([0.3, 0.5, 0.6, 1.5]) * rng.standard_normal(4), 5.0 * rng.standard_normal(1)


@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("name", list(PLANTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_step_and_dual_number_jacobians_match_jax(lib, name, method, seed):
    plant = PLANTS[name]
    n, m = plant["n"], plant["m"]
    x, u = points(name, seed)
    params = np.array(plant["params"], dtype=np.float64)
    x_next, a, b = np.empty(n), np.empty((n, n)), np.empty((n, m))
    status = lib.qt_host_step_and_jacobian(
        plant["id"], ptr(params), int(method == "rk4"), 0.01, ptr(x), ptr(u), ptr(x_next), ptr(a), ptr(b)
    )
    assert status == 0
    jdyn = jsystems.make_discrete(lambda xx, uu: plant["field"](xx, uu, plant["params"]), 0.01, method)
    np.testing.assert_allclose(x_next, np.asarray(jdyn(jnp.asarray(x), jnp.asarray(u))), rtol=1e-13, atol=1e-15)
    # linearize_dynamics reads the first H rows of x_seq: H = 1 here.
    ja, jb = jsolver.linearize_dynamics(jdyn, jnp.asarray(np.stack([x, x])), jnp.asarray(u[None]))
    np.testing.assert_allclose(a, np.asarray(ja[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b, np.asarray(jb[0]), rtol=RTOL, atol=ATOL)


def cost_tables(name, rng, full):
    n, m = PLANTS[name]["n"], PLANTS[name]["m"]
    if full:  # full, non-symmetric weights
        q = np.diag(1.0 + rng.random(n)) + 0.1 * rng.standard_normal((n, n))
        r = np.diag(0.1 + rng.random(m)) + 0.01 * rng.standard_normal((m, m))
        qf = np.diag(5.0 + rng.random(n)) + 0.1 * rng.standard_normal((n, n))
    else:
        q, r, qf = np.diag(1.0 + 9.0 * rng.random(n)), np.diag(0.01 + rng.random(m) * 0.01), np.diag(10.0 + rng.random(n))
    return q, r, qf, 0.2 * rng.standard_normal(n), 0.2 * rng.standard_normal(n)


# Controls: hover, one rotor inside the barrier, one exactly at its kink, both saturated ends.
CONTROLS = {
    "hover": [2.4, 2.5, 2.45, 2.6],
    "negative": [-0.3, 2.4, 2.45, -0.02],
    "zero": [0.0, 2.5, 0.0, 0.1],
    "saturated": [-80.0, 80.0, 0.0, 2.0],
}


@pytest.mark.parametrize("full", [False, True], ids=["diagonal", "full"])
@pytest.mark.parametrize("barrier", [0.0, 1000.0], ids=["no-barrier", "barrier"])
@pytest.mark.parametrize("controls", list(CONTROLS))
@pytest.mark.parametrize("name", list(PLANTS))
def test_analytic_cost_expansion_matches_jax(lib, name, controls, barrier, full):
    plant = PLANTS[name]
    n, m = plant["n"], plant["m"]
    rng = np.random.default_rng(3)
    q, r, qf, x_ref, xf_ref = cost_tables(name, rng, full)
    x = 0.3 * rng.standard_normal(n)
    u = np.array(CONTROLS[controls][:m])
    beta = 10.0
    out = dict(values=np.empty(2), l_x=np.empty(n), l_u=np.empty(m), l_xx=np.empty((n, n)), l_uu=np.empty((m, m)),
               l_ux=np.empty((m, n)), v_x=np.empty(n), v_xx=np.empty((n, n)))
    status = lib.qt_host_cost_and_expansion(
        plant["id"], ptr(q), ptr(r), ptr(x_ref), barrier, beta, ptr(qf), ptr(xf_ref), ptr(x), ptr(u),
        *(ptr(v) for v in out.values()),
    )
    assert status == 0

    jc = jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jnp.asarray(x_ref), barrier_alpha=barrier, barrier_beta=beta)
    jf = jsolver.make_quadratic_final_cost(jnp.asarray(qf), jnp.asarray(xf_ref))
    np.testing.assert_allclose(out["values"], [float(jc(jnp.asarray(x), jnp.asarray(u))), float(jf(jnp.asarray(x)))], rtol=1e-12)
    exp = jsolver.quadratize_cost(jc, jnp.asarray(np.stack([x, x])), jnp.asarray(u[None]))
    for field in ("l_x", "l_u", "l_xx", "l_uu", "l_ux"):
        np.testing.assert_allclose(out[field], np.asarray(getattr(exp, field)[0]), rtol=RTOL, atol=ATOL, err_msg=field)
    fin = jsolver.quadratize_final_cost(jf, jnp.asarray(x))
    np.testing.assert_allclose(out["v_x"], np.asarray(fin.v_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["v_xx"], np.asarray(fin.v_xx), rtol=RTOL, atol=ATOL)


def test_unknown_plant_is_refused(lib):
    z = np.zeros(16)
    assert lib.qt_host_step_and_jacobian(7, ptr(z), 1, 0.01, ptr(z), ptr(z), ptr(z), ptr(z), ptr(z)) == 1
