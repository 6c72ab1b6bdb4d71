"""Port parity: the batched SPD solves of ops/smallchol.py, and K8's plain form, against quattro_tpu.

K8's plain form ``batched_cholesky_solve_plain`` is held to JAX's kernel
``batched_cholesky_solve_pallas`` run in interpret mode, at the shapes
``tests/test_ops.py`` runs it at; the wrapper ``batched_cholesky_solve_fused``
takes the plain form on CPU tensors and launches nothing. Inputs from a numpy
seed, float64, rtol 1e-12 (the same unrolled operations on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.ops import smallchol as jchol
from quattro_tpu_torch.ops import _build, smallchol

RTOL = 1e-12
ATOL = 1e-13


def spd_problem(batch, m, r, seed, shift=1.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((batch, m, m))
    a = w @ np.swapaxes(w, -1, -2) + shift * np.eye(m)
    return a, rng.standard_normal((batch, m, r))


@pytest.mark.parametrize("m, r, batch", [(4, 13, 301), (4, 5, 256), (1, 2, 128)])
def test_k8_plain_matches_jax_pallas_kernel(m, r, batch):
    a, b = spd_problem(batch, m, r, seed=m * 100 + r, shift=2.0)
    ref = jchol.batched_cholesky_solve_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    out = smallchol.batched_cholesky_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (batch, m, r)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_fused_wrapper_takes_the_plain_form_on_cpu():
    a, b = spd_problem(37, 4, 9, seed=1)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    _build.reset_launches()
    out = smallchol.batched_cholesky_solve_fused(a, b)
    assert sum(_build.launches.values()) == 0
    assert torch.equal(out, smallchol.batched_cholesky_solve_plain(a, b))
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(a.numpy(), b.numpy()), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_batched_cholesky_solve_matches_jax(m):
    a, b = spd_problem(64, m, 3, seed=m)
    x, l = smallchol.batched_cholesky_solve(torch.from_numpy(a), torch.from_numpy(b))
    jx, jl = jchol.batched_cholesky_solve(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [4, 16])
def test_batched_spd_solve_dispatch_matches_jax(m):
    """Unrolled Cholesky up to m = 8, LU above (``jnp.linalg.solve`` / ``torch.linalg.solve``)."""
    a, b = spd_problem(5, m, 2, seed=20 + m)
    out = smallchol.batched_spd_solve(torch.from_numpy(a), torch.from_numpy(b))
    ref = jchol.batched_spd_solve(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "a_shape, b_shape, dtype, match",
    [((4, 9, 9), (4, 9, 2), torch.float64, "m <= 8"),
     ((4, 3, 3), (4, 3, 2), torch.float16, "float32 or float64"),
     ((4, 3, 3), (5, 3, 2), torch.float64, r"\(B, m, m\)")],
    ids=["m9", "float16", "batch-mismatch"],
)
def test_k8_refuses_what_it_does_not_take_before_launch(a_shape, b_shape, dtype, match):
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        smallchol._launch(torch.ones(a_shape, dtype=dtype), torch.ones(b_shape, dtype=dtype))
    assert sum(_build.launches.values()) == 0
