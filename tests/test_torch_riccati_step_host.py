"""One Riccati step from the kernels' arithmetic, built for the host, against the TPU step law.

K1, K3 and K4 compute every step from the QT_HD functions of
``csrc/riccati_step.cuh``: the per-output products, the register factor of
Q_uu + reg I, the substitutions and the value update.
``csrc/riccati_step_host.cpp`` composes one step from the same functions,
entry by entry, through the instance the kernels dispatch to (exact at the
quadrotor's (12, 4) and the cart-pole's (4, 1), masked at (16, 8) for any
other shape), and ``ops/_build.py`` builds it with the host C++ compiler.
This holds that step, on seeded float64 inputs, against
``quattro_tpu/ops/fused_riccati.py::riccati_step_tiles`` at rtol 1e-12 (the
same law in another summation order). Skips where no C++ compiler is found.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from quattro_tpu.ops.fused_riccati import make_tile_dot, riccati_step_tiles
from quattro_tpu_torch.ops import _build

RTOL = 1e-12
ATOL = 1e-13
DOUBLE_P = ctypes.POINTER(ctypes.c_double)
# (n, m) -> the instance the kernels run: 0 quadrotor (12, 4), 1 cart-pole (4, 1), 2 masked (16, 8).
SHAPES = {(12, 4): 0, (4, 1): 1, (7, 3): 2, (16, 8): 2, (1, 1): 2}


@pytest.fixture(scope="module")
def lib():
    if not any(shutil.which(cc) for cc in ("c++", "g++", "clang++")) or shutil.which("ninja") is None:
        pytest.skip("needs a host C++ compiler and ninja to build csrc/riccati_step_host.cpp")
    library = _build.library("riccati_step_host")
    library.qt_host_riccati_step.restype = ctypes.c_int
    library.qt_host_riccati_step.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double] + [DOUBLE_P] * 13
    library.qt_host_step_instance.restype = ctypes.c_int
    library.qt_host_step_instance.argtypes = [ctypes.c_int, ctypes.c_int]
    return library


def ptr(array):
    assert array.dtype == np.float64 and array.flags.c_contiguous
    return array.ctypes.data_as(DOUBLE_P)


def step_inputs(n, m, seed):
    """One step's stage data and carry: SPD l_xx, l_uu and V_xx, a near the identity."""
    rng = np.random.default_rng(seed)

    def spd(d):
        g = rng.standard_normal((d, d))
        return g @ g.T / d + np.eye(d)

    return dict(
        a=np.eye(n) + 0.1 * rng.standard_normal((n, n)), b=0.1 * rng.standard_normal((n, m)),
        lx=rng.standard_normal(n), lu=rng.standard_normal(m), lxx=spd(n), luu=spd(m),
        lux=0.1 * rng.standard_normal((m, n)), vx=rng.standard_normal(n), vxx=spd(n),
    )


def host_step(lib, n, m, reg, d):
    out = dict(k=np.empty(m), bigk=np.empty((m, n)), vx=np.empty(n), vxx=np.empty((n, n)))
    status = lib.qt_host_riccati_step(
        n, m, reg, *(ptr(np.ascontiguousarray(d[key])) for key in ("a", "b", "lx", "lu", "lxx", "luu", "lux", "vx", "vxx")),
        *(ptr(v) for v in out.values()),
    )
    assert status == 0
    return out


def tpu_step(n, m, reg, d):
    j = {key: jnp.asarray(v) for key, v in d.items()}
    g_u, g_x, vx_new, vxx_new = riccati_step_tiles(
        j["a"], j["a"].T, j["b"], j["b"].T, j["lx"][None], j["lu"][None], j["lxx"], j["luu"], j["lux"],
        j["lux"].T, j["vx"][None], j["vxx"], reg, make_tile_dot(jnp.float64),
    )
    return dict(k=-np.asarray(g_u)[:, 0], bigk=-np.asarray(g_x), vx=np.asarray(vx_new)[0], vxx=np.asarray(vxx_new))


@pytest.mark.parametrize("reg", [1e-6, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n, m", list(SHAPES))
def test_host_step_matches_riccati_step_tiles(lib, n, m, seed, reg):
    d = step_inputs(n, m, seed)
    assert lib.qt_host_step_instance(n, m) == SHAPES[(n, m)]
    out, ref = host_step(lib, n, m, reg, d), tpu_step(n, m, reg, d)
    for key in ("k", "bigk", "vx", "vxx"):
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("n, m", [(12, 4), (4, 1)])
def test_host_steps_chain_like_the_tpu_recursion(lib, n, m):
    """Ten steps carried through V: the carry the kernels keep in shared memory stays on JAX's."""
    d = step_inputs(n, m, 100)
    vx, vxx = d["vx"], d["vxx"]
    jvx, jvxx = vx, vxx
    for seed in range(10):
        stage = step_inputs(n, m, seed + 200)
        out = host_step(lib, n, m, 1e-6, {**stage, "vx": vx, "vxx": vxx})
        ref = tpu_step(n, m, 1e-6, {**stage, "vx": jvx, "vxx": jvxx})
        vx, vxx, jvx, jvxx = out["vx"], out["vxx"], ref["vx"], ref["vxx"]
    np.testing.assert_allclose(vxx, jvxx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vx, jvx, rtol=RTOL, atol=ATOL)


def test_out_of_range_shapes_are_refused(lib):
    z = np.zeros(17 * 17)
    assert lib.qt_host_riccati_step(17, 4, 1e-6, *([ptr(z)] * 13)) == 1
    assert lib.qt_host_riccati_step(12, 9, 1e-6, *([ptr(z)] * 13)) == 1
