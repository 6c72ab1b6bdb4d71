"""Port parity: the unrolled no-pivot LU (ops/smalllu.py) against quattro_tpu.

The associative Riccati combine's shape, ``I + C J`` with C, J PSD, from a
numpy seed, float64. The port and JAX run the same dense masked elimination,
so they agree to rtol 1e-12; the solves are also held to a pivoting library
solve at JAX's own tolerance (``tests/test_ops.py``: rtol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.ops import smalllu as jlu
from quattro_tpu_torch.ops import smalllu

RTOL = 1e-12
ATOL = 1e-13


def combine_problem(n, batch, seed, r=None):
    rng = np.random.default_rng(seed)
    wc = rng.standard_normal((batch, n, n))
    wj = rng.standard_normal((batch, n, n))
    c = wc @ np.swapaxes(wc, -1, -2)
    j = 0.5 * wj @ np.swapaxes(wj, -1, -2)
    a = np.eye(n) + c @ j
    b = rng.standard_normal((batch, n, 2 * n + 1 if r is None else r))
    return a, b


@pytest.mark.parametrize("n", [1, 4, 12])
def test_unrolled_lu_matches_jax(n):
    a, _ = combine_problem(n, 7, seed=n)
    np.testing.assert_allclose(smalllu.unrolled_lu(torch.from_numpy(a)).numpy(),
                               np.asarray(jlu.unrolled_lu(jnp.asarray(a))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [4, 12])
def test_lu_solve_matches_jax_and_a_pivoting_solve(n, transpose):
    a, b = combine_problem(n, 9, seed=10 + n)
    out = smalllu.lu_solve(smalllu.unrolled_lu(torch.from_numpy(a)), torch.from_numpy(b), transpose=transpose)
    ref = jlu.lu_solve(jlu.unrolled_lu(jnp.asarray(a)), jnp.asarray(b), transpose=transpose)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    lhs = np.swapaxes(a, -1, -2) if transpose else a
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(lhs, b), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("refine_steps", [0, 1, 2])
@pytest.mark.parametrize("transpose", [False, True])
def test_batched_small_solve_matches_jax(transpose, refine_steps):
    """Leading batch axes of any rank, as the combine calls it on (horizon, batch) stacks."""
    a, b = combine_problem(8, 12, seed=3, r=5)
    a, b = a.reshape(3, 4, 8, 8), b.reshape(3, 4, 8, 5)
    out = smalllu.batched_small_solve(torch.from_numpy(a), torch.from_numpy(b), transpose, refine_steps)
    ref = jlu.batched_small_solve(jnp.asarray(a), jnp.asarray(b), transpose, refine_steps)
    assert out.shape == (3, 4, 8, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_refinement_tightens_float32():
    """JAX's check (``tests/test_ops.py``): in float32 one refinement step lands within ~10x
    of the pivoted LU's own error against the float64 solution."""
    a, b = combine_problem(12, 64, seed=2)
    exact = np.linalg.solve(a, b)
    a32, b32 = torch.from_numpy(a).float(), torch.from_numpy(b).float()
    lu32 = torch.linalg.solve(a32, b32).double().numpy()
    ours32 = smalllu.batched_small_solve(a32, b32, refine_steps=1).double().numpy()
    scale = np.abs(exact).max()
    err_lu = np.abs(lu32 - exact).max() / scale
    err_ours = np.abs(ours32 - exact).max() / scale
    assert err_ours < 10 * err_lu + 1e-6, (err_ours, err_lu)
