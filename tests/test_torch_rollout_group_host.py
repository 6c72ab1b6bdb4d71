"""The lane-group rollout of K2 and K6/K7, built for the host, against the TPU kernel.

K2 and K6/K7 run each candidate on a group of G lanes (``csrc/rollout_group.cuh``:
G = 4 for the quadrotor, whose field's trig and quotients are spread over the
lanes and exchanged by shuffles; G = 1 for the cart-pole).
``csrc/rollout_group_host.cpp`` runs the same QT_HD per-lane parts on the host,
lane after lane, with arrays in place of the shuffles, and ``ops/_build.py``
builds it with the host C++ compiler. This holds whole rollouts from it, on
seeded float64 inputs, against ``quattro_tpu/ops/fused_rollout.py::
fused_feedback_rollouts`` in interpret mode at rtol 1e-12 (the same law; the
feedback sums are taken in another order), atol 1e-13 for entries near zero.
It is the one check of the group's arithmetic that runs without the card.
Skips where no C++ compiler or ninja is found.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from quattro_tpu import systems as jsystems
from quattro_tpu.ops.fused_rollout import fused_feedback_rollouts
from quattro_tpu_torch.ops import _build

RTOL = 1e-12
ATOL = 1e-13
DT = 0.01
DOUBLE_P = ctypes.POINTER(ctypes.c_double)
PLANTS = {
    "quadrotor": dict(id=0, n=12, m=4, width=4, field=jsystems.quadrotor_dynamics,
                      params=jsystems.QuadrotorParams(mass=1.3, arm=0.12)),
    "cartpole": dict(id=1, n=4, m=1, width=1, field=jsystems.cartpole_dynamics,
                     params=jsystems.CartPoleParams(m_pole=0.2, length=0.2)),
}


@pytest.fixture(scope="module")
def lib():
    if not any(shutil.which(cc) for cc in ("c++", "g++", "clang++")) or shutil.which("ninja") is None:
        pytest.skip("needs a host C++ compiler and ninja to build csrc/rollout_group_host.cpp")
    library = _build.library("rollout_group_host")
    library.qt_host_group_rollout.restype = ctypes.c_int
    library.qt_host_group_rollout.argtypes = (
        [ctypes.c_int, DOUBLE_P, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int] + [DOUBLE_P] * 8
    )
    library.qt_host_group_width.restype = ctypes.c_int
    library.qt_host_group_width.argtypes = [ctypes.c_int]
    return library


def ptr(array):
    assert array.dtype == np.float64 and array.flags.c_contiguous
    return array.ctypes.data_as(DOUBLE_P)


def rollout_inputs(name, horizon, n_alpha, seed):
    """x0, x_ref (H+1, n), u_ref, k, K and A step sizes from 1 down to 1e-3."""
    rng = np.random.default_rng(seed)
    alphas = np.geomspace(1.0, 1e-3, n_alpha) if n_alpha > 1 else np.ones(1)
    if name == "quadrotor":
        return (0.1 * rng.standard_normal(12), 0.1 * rng.standard_normal((horizon + 1, 12)),
                3.19 + 0.1 * rng.standard_normal((horizon, 4)), 0.05 * rng.standard_normal((horizon, 4)),
                0.05 * rng.standard_normal((horizon, 4, 12)), alphas)
    return (0.1 * rng.standard_normal(4), 0.1 * rng.standard_normal((horizon + 1, 4)),
            0.5 * rng.standard_normal((horizon, 1)), 0.5 * rng.standard_normal((horizon, 1)),
            0.5 * rng.standard_normal((horizon, 1, 4)), alphas)


def host_rollouts(lib, name, method, inputs):
    plant = PLANTS[name]
    x0, x_ref, u_ref, k, big_k, alphas = inputs
    horizon, n_alpha, n, m = u_ref.shape[0], alphas.shape[0], plant["n"], plant["m"]
    cand_x, cand_u = np.empty((n_alpha, horizon + 1, n)), np.empty((n_alpha, horizon, m))
    params = np.array(plant["params"], dtype=np.float64)
    status = lib.qt_host_group_rollout(
        plant["id"], ptr(params), int(method == "rk4"), DT, horizon, n_alpha,
        *(ptr(np.ascontiguousarray(v)) for v in (x0, x_ref[:horizon], u_ref, k, big_k, alphas)),
        ptr(cand_x), ptr(cand_u),
    )
    assert status == 0
    return cand_x, cand_u


@pytest.mark.parametrize("n_alpha", [1, 6, 9])
@pytest.mark.parametrize("horizon", [1, 13, 16])
@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("name", list(PLANTS))
def test_group_rollout_matches_the_tpu_kernel(lib, name, method, horizon, n_alpha):
    plant = PLANTS[name]
    inputs = rollout_inputs(name, horizon, n_alpha, seed=horizon * 10 + n_alpha)
    cand_x, cand_u = host_rollouts(lib, name, method, inputs)
    jdyn = jsystems.make_discrete(lambda x, u: plant["field"](x, u, plant["params"]), DT, method)
    ref_x, ref_u = fused_feedback_rollouts(jdyn, *(jnp.asarray(v) for v in inputs), interpret=True)
    np.testing.assert_allclose(cand_x, np.asarray(ref_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cand_u, np.asarray(ref_u), rtol=RTOL, atol=ATOL)


def test_group_widths_and_refusals(lib):
    assert [lib.qt_host_group_width(p) for p in (0, 1, 2)] == [4, 1, 0]
    z = np.zeros(64)
    assert lib.qt_host_group_rollout(2, ptr(z), 1, DT, 1, 1, *([ptr(z)] * 8)) == 1
    assert lib.qt_host_group_rollout(0, ptr(z), 1, DT, 1, 0, *([ptr(z)] * 8)) == 1
