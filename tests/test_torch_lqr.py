"""Port parity: the DARE solver, the LQR gain and the blending weight against quattro_tpu.

Seeded float64 inputs through both packages. The doubling iteration runs 30
sweeps of small linear solves in both; rtol 1e-9 allows for the two LU
implementations. The blending weight is one norm and a clip: rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.control.switcher import blending_weight as j_blending_weight
from quattro_tpu.solver import lqr_gain as j_lqr_gain
from quattro_tpu.solver import solve_dare as j_solve_dare
from quattro_tpu.systems import CartPoleParams as JCartPoleParams
from quattro_tpu.systems import cartpole_linearized as j_cartpole_linearized
from quattro_tpu_torch.control import blending_weight
from quattro_tpu_torch.solver import lqr_gain, solve_dare
from quattro_tpu_torch.systems import cartpole_linearized

RTOL = 1e-9


def random_system(seed, n=5, m=2):
    rng = np.random.default_rng(seed)
    a = np.eye(n) + 0.2 * rng.standard_normal((n, n))
    b = rng.standard_normal((n, m))
    gq, gr = rng.standard_normal((n, n)), rng.standard_normal((m, m))
    return a, b, gq @ gq.T / n + np.eye(n), gr @ gr.T / m + np.eye(m)


def cartpole_system():
    a_c, b_c = (np.asarray(v) for v in j_cartpole_linearized(JCartPoleParams()))
    return np.eye(4) + 0.01 * a_c, 0.01 * b_c, np.diag([1.0, 0.1, 10.0, 0.1]), np.diag([0.001])


@pytest.mark.parametrize("system", [lambda: random_system(0), lambda: random_system(1, n=12, m=4), cartpole_system],
                         ids=["random-5x2", "random-12x4", "cartpole"])
def test_solve_dare_and_lqr_gain_match_jax(system):
    mats = system()
    jm = [jnp.asarray(v) for v in mats]
    tm = [torch.from_numpy(v) for v in mats]
    np.testing.assert_allclose(solve_dare(*tm).numpy(), np.asarray(j_solve_dare(*jm)), rtol=RTOL, atol=1e-12)
    jk, jp = j_lqr_gain(*jm)
    tk, tp = lqr_gain(*tm)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=1e-12)


def test_solve_dare_satisfies_the_riccati_equation():
    a, b, q, r = (torch.from_numpy(v) for v in random_system(2))
    p = solve_dare(a, b, q, r)
    residual = a.T @ p @ a - a.T @ p @ b @ torch.linalg.solve(r + b.T @ p @ b, b.T @ p @ a) + q - p
    assert float(residual.abs().max()) < 1e-9 * float(p.abs().max())
    k, _ = lqr_gain(a, b, q, r)
    assert float(torch.linalg.eigvals(a - b @ k).abs().max()) < 1.0  # u = -K dx stabilizes


def test_cartpole_lqr_matrices_are_the_same_in_both_packages():
    ja, jb = j_cartpole_linearized(JCartPoleParams())
    ta, tb = cartpole_linearized(device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-15)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-15)


@pytest.mark.parametrize("scale", [0.05, 0.2, 0.5, 1.0, 2.0])
def test_blending_weight_matches_jax(scale):
    err = scale * np.random.default_rng(1).standard_normal(4)
    ref = j_blending_weight(jnp.asarray(err), 0.5, 1.5)
    out = blending_weight(torch.from_numpy(err), 0.5, 1.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
    assert 0.0 <= float(out) <= 1.0


@pytest.mark.parametrize("norm,weight", [(0.5, 0.0), (1.5, 1.0), (1.0, 0.5), (0.1, 0.0), (9.0, 1.0)])
def test_blending_weight_thresholds(norm, weight):
    err = torch.tensor([norm, 0.0, 0.0, 0.0], dtype=torch.float64)
    assert float(blending_weight(err)) == pytest.approx(weight, abs=1e-12)
    assert float(j_blending_weight(jnp.asarray(err.numpy()))) == pytest.approx(weight, abs=1e-12)
