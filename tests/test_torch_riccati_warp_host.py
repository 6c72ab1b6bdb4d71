"""K4's warp step, built for the host, against K1's step and the TPU step law.

K4 (``csrc/fused_riccati_batched.cu``) runs one warp per trajectory; each
lane computes 4 x 2 tiles of every phase from the QT_HD functions of
``csrc/riccati_warp.cuh``. ``csrc/riccati_warp_host.cpp`` composes one step
from those functions, tile after tile, and ``ops/_build.py`` builds it with
the host C++ compiler. On seeded float64 inputs this holds that step

- bit for bit against ``csrc/riccati_step_host.cpp``, the step of
  ``csrc/riccati_step.cuh`` that K1 runs: every output is the same chain of
  operations in the same order (the device's FMA contraction follows the
  same data flow in both, so a K4 lane equals K1 on the card);
- against ``quattro_tpu/ops/fused_riccati.py::riccati_step_tiles`` at rtol
  1e-12 (the same law in another summation order).

Skips where no C++ compiler or ninja is found.
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
KEYS = ("a", "b", "lx", "lu", "lxx", "luu", "lux", "vx", "vxx")
# Both exact instances, the masked one at several runtime shapes (odd n puts x and u in one tile's reach).
SHAPES = [(12, 4), (4, 1), (7, 3), (16, 8), (1, 1), (5, 2), (13, 7)]


def _load(source, symbol):
    if not any(shutil.which(cc) for cc in ("c++", "g++", "clang++")) or shutil.which("ninja") is None:
        pytest.skip(f"needs a host C++ compiler and ninja to build csrc/{source}.cpp")
    fn = getattr(_build.library(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double] + [DOUBLE_P] * 13
    return fn


@pytest.fixture(scope="module")
def warp_step():
    return _load("riccati_warp_host", "qt_host_warp_riccati_step")


@pytest.fixture(scope="module")
def k1_step():
    return _load("riccati_step_host", "qt_host_riccati_step")


def ptr(array):
    assert array.dtype == np.float64 and array.flags.c_contiguous
    return array.ctypes.data_as(DOUBLE_P)


def step_inputs(n, m, seed):
    """One step's stage data and carry: SPD l_xx, l_uu, a near the identity, V_xx not symmetric
    (the kernels' carry is not re-symmetrized, so a transposed read would show)."""
    rng = np.random.default_rng(seed)

    def spd(d):
        g = rng.standard_normal((d, d))
        return g @ g.T / d + np.eye(d)

    vxx = spd(n)
    return dict(
        a=np.eye(n) + 0.1 * rng.standard_normal((n, n)), b=0.1 * rng.standard_normal((n, m)),
        lx=rng.standard_normal(n), lu=rng.standard_normal(m), lxx=spd(n), luu=spd(m),
        lux=0.1 * rng.standard_normal((m, n)), vx=rng.standard_normal(n),
        vxx=vxx + 1e-3 * rng.standard_normal((n, n)),
    )


def run(fn, n, m, reg, d):
    out = dict(k=np.empty(m), bigk=np.empty((m, n)), vx=np.empty(n), vxx=np.empty((n, n)))
    status = fn(n, m, reg, *(ptr(np.ascontiguousarray(d[key])) for key in KEYS), *(ptr(v) for v in out.values()))
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
@pytest.mark.parametrize("n, m", SHAPES)
def test_warp_step_is_k1_step_bit_for_bit(warp_step, k1_step, n, m, seed, reg):
    d = step_inputs(n, m, seed)
    out, ref = run(warp_step, n, m, reg, d), run(k1_step, n, m, reg, d)
    for key in ("k", "bigk", "vx", "vxx"):
        assert np.array_equal(out[key], ref[key]), key


@pytest.mark.parametrize("reg", [1e-6, 0.5])
@pytest.mark.parametrize("n, m", [(12, 4), (4, 1), (7, 3)])
def test_warp_step_matches_riccati_step_tiles(warp_step, n, m, reg):
    d = step_inputs(n, m, 7)
    out, ref = run(warp_step, n, m, reg, d), tpu_step(n, m, reg, d)
    for key in ("k", "bigk", "vx", "vxx"):
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("n, m", [(12, 4), (4, 1), (7, 3)])
def test_warp_steps_chain_like_k1(warp_step, k1_step, n, m):
    """Ten steps carried through the transposed carry: equal to K1's chain bit for bit, near JAX's."""
    d = step_inputs(n, m, 100)
    vx, vxx, kvx, kvxx = d["vx"], d["vxx"], d["vx"], d["vxx"]
    jvx, jvxx = vx, vxx
    for seed in range(10):
        stage = step_inputs(n, m, seed + 200)
        out = run(warp_step, n, m, 1e-6, {**stage, "vx": vx, "vxx": vxx})
        ref = run(k1_step, n, m, 1e-6, {**stage, "vx": kvx, "vxx": kvxx})
        jax_ref = tpu_step(n, m, 1e-6, {**stage, "vx": jvx, "vxx": jvxx})
        assert all(np.array_equal(out[key], ref[key]) for key in out)
        vx, vxx, kvx, kvxx = out["vx"], out["vxx"], ref["vx"], ref["vxx"]
        jvx, jvxx = jax_ref["vx"], jax_ref["vxx"]
    np.testing.assert_allclose(vxx, jvxx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vx, jvx, rtol=RTOL, atol=ATOL)


def test_warp_step_refuses_out_of_range_shapes(warp_step):
    z = np.zeros(17 * 17)
    assert warp_step(17, 4, 1e-6, *([ptr(z)] * 13)) == 1
    assert warp_step(12, 9, 1e-6, *([ptr(z)] * 13)) == 1
