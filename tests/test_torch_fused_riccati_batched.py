"""Port parity: the batched backward pass (K4's plain forms) against quattro_tpu.

The JAX kernels (``riccati_backward_batched_fused``, ``..._fused2d``, with and
without ``packed_stage``, and ``..._fused_auto``) run in interpret mode, as
``tests/test_fused_riccati.py`` runs them, at that file's shapes, including
its batch- and horizon-pad cases. Inputs are random LQ stages from a numpy
seed. float64 rtol 1e-9 (the TPU batch2d kernel re-symmetrizes its carry, the
port runs K1's law: only rounding differs). bfloat16 stream (float32 data):
against JAX's at 1e-5 normwise (the same round-to-nearest-even of the inputs,
float32 arithmetic in another order), and within JAX's 5e-2 band of float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.ops import fused_riccati as jfr
from quattro_tpu.ops.fused_linquad import unpack_stage as j_unpack_stage
from quattro_tpu.solver.derivatives import CostExpansion as JCostExpansion
from quattro_tpu_torch.ops import _build, fused_riccati
from quattro_tpu_torch.solver import CostExpansion

RTOL = 1e-9
ATOL = 1e-9
REG = 1e-6


def problem(batch, horizon, n, m, seed=0, dtype=np.float64):
    """(numpy stages a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx) of random LQ problems."""
    rng = np.random.default_rng(seed)
    sh = (batch, horizon)
    a = np.eye(n) + 0.1 * rng.standard_normal((*sh, n, n))
    b = 0.3 * rng.standard_normal((*sh, n, m))
    w = rng.standard_normal((*sh, n, n))
    wu = rng.standard_normal((*sh, m, m))
    l_x = rng.standard_normal((*sh, n))
    l_u = rng.standard_normal((*sh, m))
    l_xx = 0.3 * w @ np.swapaxes(w, -1, -2) + 0.2 * np.eye(n)
    l_uu = wu @ np.swapaxes(wu, -1, -2) + 0.5 * np.eye(m)
    l_ux = 0.1 * rng.standard_normal((*sh, m, n))
    wf = rng.standard_normal((batch, n, n))
    v_xx = wf @ np.swapaxes(wf, -1, -2) + np.eye(n)
    v_x = rng.standard_normal((batch, n))
    return [x.astype(dtype) for x in (a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx)]


def jax_args(p):
    a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx = (jnp.asarray(x) for x in p)
    return a, b, JCostExpansion(l_x, l_u, l_xx, l_uu, l_ux), v_x, v_xx


def torch_args(p):
    a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx = (torch.from_numpy(x) for x in p)
    return a, b, CostExpansion(l_x, l_u, l_xx, l_uu, l_ux), v_x, v_xx


def close(ref, out, rtol=RTOL, atol=ATOL):
    for r, o in zip(ref, out):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "batch,horizon,n,m,block_t",
    [(5, 16, 3, 2, 8), (4, 13, 4, 1, 8), (3, 12, 12, 4, 4), (130, 8, 3, 2, 8)],
    ids=["batch-pad", "horizon-pad", "flagship", "multi-tile"],
)
def test_column_major_matches_jax(batch, horizon, n, m, block_t):
    p = problem(batch, horizon, n, m)
    ref = jfr.riccati_backward_batched_fused(*jax_args(p), REG, interpret=True, block_t=block_t)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_batched_fused(*torch_args(p), REG)
    assert sum(_build.launches.values()) == 0  # CPU tensors take the plain form
    close(ref, out)


@pytest.mark.parametrize(
    "batch,horizon,n,m,tile_s,block_t",
    [(5, 11, 3, 2, 1, 2), (300, 7, 5, 3, 2, 4), (4, 13, 12, 4, 1, 2)],
    ids=["pad-both", "multi-tile", "flagship"],
)
def test_batch2d_matches_jax(batch, horizon, n, m, tile_s, block_t):
    p = problem(batch, horizon, n, m)
    ref = jfr.riccati_backward_batched_fused2d(*jax_args(p), REG, interpret=True, tile_s=tile_s, block_t=block_t)
    out = fused_riccati.riccati_backward_batched_fused2d(*torch_args(p), REG, tile_s=tile_s, block_t=block_t)
    close(ref, out)


def test_auto_matches_jax():
    p = problem(6, 6, 4, 2, seed=2)
    ref = jfr.riccati_backward_batched_fused_auto(*jax_args(p), REG, interpret=True)
    close(ref, fused_riccati.riccati_backward_batched_fused_auto(*torch_args(p), REG))


def packed(p, tile_s, h_pad):
    """The stages of ``p`` in the packed layout, identity pad steps prepended."""
    a, b, l_x, l_u, l_xx, l_uu, l_ux = (torch.from_numpy(x) for x in p[:7])
    return fused_riccati.pack_stages((a, b, l_xx, l_uu, l_ux, l_x, l_u), tile_s, h_pad)


@pytest.mark.parametrize("batch,horizon,tile_s,block_t", [(128, 7, 1, 2), (256, 6, 2, 3)])
def test_packed_path_matches_jax(batch, horizon, tile_s, block_t):
    n, m = 12, 4
    p = problem(batch, horizon, n, m, seed=4)
    h_pad = -(-horizon // block_t) * block_t
    stages = packed(p, tile_s, h_pad)
    # The port's layout is JAX's: JAX's unpack_stage reads it back.
    for x, raw, tail in zip(stages, (p[0], p[1], p[4], p[5], p[6], p[2], p[3]), fused_riccati.stage_shapes(n, m)):
        np.testing.assert_array_equal(np.asarray(j_unpack_stage(jnp.asarray(x.numpy()), batch, horizon, tail, tile_s)),
                                      raw)
    v_x, v_xx = torch.from_numpy(p[7]), torch.from_numpy(p[8])
    ref = jfr.riccati_backward_batched_fused2d(
        None, None, None, jnp.asarray(p[7]), jnp.asarray(p[8]), REG, interpret=True, tile_s=tile_s,
        block_t=block_t, packed_stage=tuple(jnp.asarray(x.numpy()) for x in stages), horizon=horizon,
    )
    out = fused_riccati.riccati_backward_batched_fused2d(
        None, None, None, v_x, v_xx, REG, tile_s=tile_s, block_t=block_t, packed_stage=stages, horizon=horizon)
    close(ref, out)


def test_packed_path_errors_as_in_jax():
    p = problem(128, 7, 12, 4)
    stages = packed(p, 1, 8)
    v_x, v_xx = torch.from_numpy(p[7]), torch.from_numpy(p[8])
    with pytest.raises(ValueError, match="batch % \\(tile_s\\*128\\)"):
        fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x[:64], v_xx[:64], packed_stage=stages,
                                                       horizon=7, tile_s=1)
    with pytest.raises(ValueError, match="unpadded horizon"):
        fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, packed_stage=stages, tile_s=1)
    with pytest.raises(ValueError, match="divisible by block_t"):
        fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, packed_stage=stages, horizon=7,
                                                       tile_s=1, block_t=3)


@pytest.mark.parametrize("entry", ["column", "batch2d"])
def test_bf16_stream_matches_jax(entry):
    p = problem(4, 12, 12, 4, seed=5, dtype=np.float32)
    if entry == "column":
        jfn, tfn, kw = jfr.riccati_backward_batched_fused, fused_riccati.riccati_backward_batched_fused, {}
    else:
        jfn, tfn, kw = jfr.riccati_backward_batched_fused2d, fused_riccati.riccati_backward_batched_fused2d, {
            "tile_s": 1, "block_t": 2}
    ref16 = jfn(*jax_args(p), REG, interpret=True, stream_dtype=jnp.bfloat16, **kw)
    out16 = tfn(*torch_args(p), REG, stream_dtype=torch.bfloat16, **kw)
    out32 = tfn(*torch_args(p), REG, **kw)
    for r, o, o32 in zip(ref16, out16, out32):
        assert o.dtype == torch.float32
        r = torch.from_numpy(np.array(r))
        assert float((o - r).abs().max() / r.abs().max()) < 1e-5
        band = float((o - o32).abs().max() / o32.abs().max())
        assert 0.0 < band < 5e-2  # quantized, not a silent no-op
