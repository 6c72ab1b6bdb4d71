"""K5's Jacobians (one value pass, then tangent-only columns), built for the host, against jax.jacfwd.

K5 (``csrc/fused_linquad.cu``) evaluates the step once per point with
``discrete_step_points`` (``csrc/plants.cuh``), keeping what the field's
derivative needs at each of its evaluations, and then each column of
[A | B] with ``discrete_step_tangent_column`` on those values alone.
``csrc/host_derivatives.cpp`` exposes the same functions to the host
(``qt_host_step_tangent_jacobian``), built with the host C++ compiler through
``ops/_build.py``. Held here, float64, against ``jax.jacfwd`` of the JAX
package's step (``quattro_tpu.solver.linearize_dynamics``) at rtol 1e-12, for
both plants, Euler and RK4, at seeded points and at large pitch (where tan and
1/cos(pitch) grow). Skips where no C++ compiler or ninja is found.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch.ops import _build

RTOL = 1e-12
ATOL = 1e-13
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
    library.qt_host_step_tangent_jacobian.restype = ctypes.c_int
    library.qt_host_step_tangent_jacobian.argtypes = (
        [ctypes.c_int, DOUBLE_P, ctypes.c_int, ctypes.c_double] + [DOUBLE_P] * 4
    )
    return library


def ptr(array):
    assert array.dtype == np.float64 and array.flags.c_contiguous
    return array.ctypes.data_as(DOUBLE_P)


def point(name, case):
    """Seeded points; "pitch" cases put the quadrotor's pitch (the cart-pole's angle) far from level."""
    rng = np.random.default_rng(case)
    if name == "quadrotor":
        x, u = 0.3 * rng.standard_normal(12), 2.45 + 0.5 * rng.standard_normal(4)
        if case >= 10:
            x[7] = (1.2, -1.45, 1.5)[case - 10]
            x[6], x[8] = 0.9, -2.5
        return x, u
    x, u = np.array([0.3, 0.5, 0.6, 1.5]) * rng.standard_normal(4), 5.0 * rng.standard_normal(1)
    if case >= 10:
        x[2] = (1.2, -2.9, 3.1)[case - 10]
    return x, u


@pytest.mark.parametrize("case", [0, 1, 2, 10, 11, 12], ids=["seed0", "seed1", "seed2", "pitch1", "pitch2", "pitch3"])
@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("name", list(PLANTS))
def test_tangent_only_jacobian_matches_jacfwd(lib, name, method, case):
    plant = PLANTS[name]
    n, m = plant["n"], plant["m"]
    x, u = point(name, case)
    params = np.array(plant["params"], dtype=np.float64)
    a, b = np.empty((n, n)), np.empty((n, m))
    status = lib.qt_host_step_tangent_jacobian(plant["id"], ptr(params), int(method == "rk4"), 0.01, ptr(x), ptr(u),
                                               ptr(a), ptr(b))
    assert status == 0
    jdyn = jsystems.make_discrete(lambda xx, uu: plant["field"](xx, uu, plant["params"]), 0.01, method)
    # linearize_dynamics (jax.jacfwd of the step) reads the first H rows of x_seq: H = 1 here.
    ja, jb = jsolver.linearize_dynamics(jdyn, jnp.asarray(np.stack([x, x])), jnp.asarray(u[None]))
    np.testing.assert_allclose(a, np.asarray(ja[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b, np.asarray(jb[0]), rtol=RTOL, atol=ATOL)


def test_unknown_plant_is_refused(lib):
    z = np.zeros(16)
    assert lib.qt_host_step_tangent_jacobian(2, ptr(z), 1, 0.01, ptr(z), ptr(z), ptr(z), ptr(z)) == 1
