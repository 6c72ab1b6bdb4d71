"""Port parity: backward Riccati passes against quattro_tpu.

Random SPD-ish stages from a numpy seed, H=8, n=12, m=4, float64, rtol 1e-9.
The plain form of K1 is held to the JAX fused kernel (run in interpret
mode); ``riccati_backward`` to the JAX sequential form (each to its own
counterpart: only the latter symmetrizes V_xx).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.ops.fused_riccati import riccati_backward_fused_single as j_fused_single
from quattro_tpu.solver.derivatives import CostExpansion as JCostExpansion
from quattro_tpu.solver import riccati_backward as j_riccati_backward
from quattro_tpu_torch.ops import _build, fused_riccati
from quattro_tpu_torch.ops.fused_riccati import riccati_backward_fused_single_plain
from quattro_tpu_torch.solver import CostExpansion, riccati_backward, riccati_backward_auto, riccati_backward_fused
from quattro_tpu_torch.solver.riccati import riccati_backward_associative

RTOL = 1e-9
ATOL = 1e-11


def stages(seed=5, horizon=8, n=12, m=4):
    rng = np.random.default_rng(seed)

    def spd(d):
        g = rng.standard_normal((horizon, d, d))
        return g @ np.swapaxes(g, -1, -2) / d + np.eye(d)

    a = np.eye(n) + 0.1 * rng.standard_normal((horizon, n, n))
    b = 0.1 * rng.standard_normal((horizon, n, m))
    l_x = rng.standard_normal((horizon, n))
    l_u = rng.standard_normal((horizon, m))
    l_xx, l_uu = spd(n), spd(m)
    l_ux = 0.1 * rng.standard_normal((horizon, m, n))
    g = rng.standard_normal((n, n))
    v_x = rng.standard_normal(n)
    v_xx = g @ g.T / n + np.eye(n)
    return a, b, (l_x, l_u, l_xx, l_uu, l_ux), v_x, v_xx


def _to_torch(a, b, exp, v_x, v_xx, device="cpu"):
    t = lambda v: torch.from_numpy(v).to(device)
    return t(a), t(b), CostExpansion(*(t(e) for e in exp)), t(v_x), t(v_xx)


def _to_jax(a, b, exp, v_x, v_xx):
    return jnp.asarray(a), jnp.asarray(b), JCostExpansion(*(jnp.asarray(e) for e in exp)), jnp.asarray(v_x), jnp.asarray(v_xx)


def _close_all(ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.cpu().numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reg", [1e-6, 0.3])
def test_plain_k1_matches_jax_fused_kernel(reg):
    data = stages()
    ref = j_fused_single(*_to_jax(*data), reg, interpret=True)
    out = riccati_backward_fused_single_plain(*_to_torch(*data), reg)
    _close_all(ref, out)


def test_riccati_backward_matches_jax_sequential():
    data = stages(seed=6)
    ref = j_riccati_backward(*_to_jax(*data), 1e-6)
    out = riccati_backward(*_to_torch(*data), 1e-6)
    _close_all(ref, out)
    np.testing.assert_array_equal(out.v_xx_seq.numpy(), np.swapaxes(out.v_xx_seq.numpy(), -1, -2))


def test_cpu_dispatch_takes_plain_forms():
    """CPU tensors reach no kernel; ``riccati_backward_auto`` takes JAX's branch there
    (``tests/test_riccati.py::test_auto_dispatch_matches_both_forms``): the sequential
    form below the crossover horizon or for a batch, the associative form for one
    trajectory from H = 16 on."""
    data = _to_torch(*stages(seed=7))
    _build.reset_launches()
    fused = riccati_backward_fused(*data, 1e-6)
    _close_all(riccati_backward_fused_single_plain(*data, 1e-6), fused)
    auto = riccati_backward_auto(*data, 1e-6)  # H = 8 < 16
    _close_all(riccati_backward(*data, 1e-6), auto)
    long = _to_torch(*stages(seed=7, horizon=40))
    seq = riccati_backward(*long, 1e-6)
    _close_all(seq, riccati_backward_auto(*long, 1e-6, batch_size=64))
    auto = riccati_backward_auto(*long, 1e-6)
    _close_all(riccati_backward_associative(*long, 1e-6), auto)
    # reg sits on l_uu in the associative form, on Q_uu in the sequential one: JAX's tolerance.
    np.testing.assert_allclose(auto.k_seq.numpy(), seq.k_seq.numpy(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(auto.big_k_seq.numpy(), seq.big_k_seq.numpy(), rtol=1e-3, atol=1e-6)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("n, m", [(17, 4), (12, 9)])
def test_k1_refuses_shapes_beyond_its_bounds_before_launch(n, m):
    data = _to_torch(*stages(seed=9, horizon=2, n=n, m=m))
    _build.reset_launches()
    with pytest.raises(ValueError, match="n <= 16 and m <= 8"):
        fused_riccati._launch(*data, 1e-6)
    assert sum(_build.launches.values()) == 0

