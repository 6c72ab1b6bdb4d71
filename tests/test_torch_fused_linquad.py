"""Port parity: fused linearize + quadratize (K5's plain form) against quattro_tpu.

JAX's ``linquad_batched_fused`` runs in interpret mode at the shapes of
``tests/test_fused_linquad.py``: quadrotor RK4, B=128, tile_s=1, H=7 with
block_t=2 (one prepended pad step, the pad-overwrite path), float64, inputs
from a numpy seed. The packed tensors are compared element for element at
rtol 1e-10 (two autodiff implementations of the same derivatives); the
K5 -> K4 chain at the batched Riccati tolerance, 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.ops.fused_linquad import linquad_batched_fused as j_linquad
from quattro_tpu.ops.fused_linquad import unpack_stage as j_unpack_stage
from quattro_tpu.ops.fused_riccati import riccati_backward_batched_fused2d as j_fused2d
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build, fused_linquad, fused_riccati

N, M = 12, 4
RTOL = 1e-10
ATOL = 1e-12
SHAPES = [(N, N), (N, M), (N, N), (M, M), (M, N), (N,), (M,)]


def setup(batch, horizon, seed=3):
    """(jax (dyn, cost, fcost, xs, us), torch (dyn, cost, fcost, xs, us)) with the JAX test's cost."""
    rng = np.random.default_rng(seed)
    x_ref = np.zeros(N)
    x_ref[2] = 0.5
    xs = 0.1 * rng.standard_normal((batch, horizon + 1, N))
    us = 2.4 + 0.1 * rng.standard_normal((batch, horizon, M))
    us[0, 0, 0] = -0.2  # the barrier's other half-line
    j = (
        jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4"),
        jsolver.make_quadratic_cost(jnp.ones(N), jnp.full((M,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0),
        jsolver.make_quadratic_final_cost(jnp.ones(N) * 10, jnp.asarray(x_ref)),
        jnp.asarray(xs), jnp.asarray(us),
    )
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    tp = (
        tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4"),
        tsolver.make_quadratic_cost(t(np.ones(N)), t(np.full(M, 0.01)), t(x_ref), barrier_alpha=1000.0),
        tsolver.make_quadratic_final_cost(t(np.ones(N) * 10), t(x_ref)),
        t(xs), t(us),
    )
    return j, tp


def test_packed_tensors_match_jax():
    (jdyn, jcost, _, jxs, jus), (tdyn, tcost, _, txs, tus) = setup(128, 7)
    ref = j_linquad(jdyn, jcost, jxs, jus, interpret=True, tile_s=1, block_t=2)
    _build.reset_launches()
    out = fused_linquad.linquad_batched_fused(tdyn, tcost, txs, tus, tile_s=1, block_t=2)
    assert sum(_build.launches.values()) == 0  # CPU tensors take the plain form
    for r, o in zip(ref, out):
        assert tuple(o.shape) == tuple(r.shape) == (8, o.shape[1], 1, 128)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_unpack_stage_matches_jax_and_the_derivatives():
    (jdyn, jcost, _, jxs, jus), (tdyn, tcost, _, txs, tus) = setup(256, 5, seed=5)
    out = fused_linquad.linquad_batched_fused(tdyn, tcost, txs, tus, tile_s=2, block_t=4)
    a, b = torch.func.vmap(lambda x, u: tsolver.linearize_dynamics(tdyn, x, u))(txs, tus)
    exp = torch.func.vmap(lambda x, u: tsolver.quadratize_cost(tcost, x, u))(txs, tus)
    natural = (a, b, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u)
    for pk, shape, nat in zip(out, SHAPES, natural):
        got = fused_linquad.unpack_stage(pk, 256, 5, shape, 2)
        assert torch.equal(got, nat)
        np.testing.assert_array_equal(np.asarray(j_unpack_stage(jnp.asarray(pk.numpy()), 256, 5, shape, 2)),
                                      got.numpy())


def test_packed_chain_matches_jax():
    (jdyn, jcost, jfcost, jxs, jus), (tdyn, tcost, tfcost, txs, tus) = setup(128, 6, seed=9)
    jpk = j_linquad(jdyn, jcost, jxs, jus, interpret=True, tile_s=1, block_t=2)
    jfin = [jsolver.quadratize_final_cost(jfcost, x) for x in jxs[:, -1]]
    j_v_x = jnp.stack([f.v_x for f in jfin])
    j_v_xx = jnp.stack([f.v_xx for f in jfin])
    ref = j_fused2d(None, None, None, j_v_x, j_v_xx, interpret=True, tile_s=1, block_t=2, packed_stage=jpk,
                    horizon=6)
    tpk = fused_linquad.linquad_batched_fused(tdyn, tcost, txs, tus, tile_s=1, block_t=2)
    fin = torch.func.vmap(lambda x: tsolver.quadratize_final_cost(tfcost, x))(txs[:, -1])
    out = fused_riccati.riccati_backward_batched_fused2d(None, None, None, fin.v_x, fin.v_xx, tile_s=1, block_t=2,
                                                         packed_stage=tpk, horizon=6)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9)


def test_misaligned_batch_raises():
    _, (tdyn, tcost, _, txs, tus) = setup(64, 4)
    with pytest.raises(ValueError, match="batch % \\(tile_s\\*128\\)"):
        fused_linquad.linquad_batched_fused(tdyn, tcost, txs, tus, tile_s=1)
