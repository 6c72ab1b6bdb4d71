"""Port parity: the associative-scan Riccati family against quattro_tpu.

Random LQ problems from a numpy seed (the distribution of ``tests/test_riccati.py``'s
``random_lq_problem``), float64. The associative pass (the combine, the stage
elements, the suffix value functions, the gains) is held to JAX's own
associative form at rtol 1e-9 -- never to the sequential one, since the two
place reg differently (on l_uu here, on Q_uu there). The solves through it
are in ``test_torch_solve_assoc.py`` and ``test_torch_batch_assoc.py`` (JAX's compile of each solve takes tens
of seconds, so they live in files of their own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.solver import riccati as jric
from quattro_tpu.solver.derivatives import CostExpansion as JCostExpansion
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.solver import riccati as tric
from quattro_tpu_torch.solver.derivatives import CostExpansion

RTOL = 1e-9
ATOL = 1e-11


def random_lq(horizon, n=12, m=4, seed=0, batch=()):
    """(a, b, (l_x, l_u, l_xx, l_uu, l_ux), v_x, v_xx) as numpy arrays with leading axes ``batch + (horizon,)``."""
    rng = np.random.default_rng(seed)
    lead = tuple(batch) + (horizon,)
    tr = lambda x: np.swapaxes(x, -1, -2)
    a = np.eye(n) + 0.01 * rng.standard_normal(lead + (n, n))
    b = 0.1 * rng.standard_normal(lead + (n, m))
    w = rng.standard_normal(lead + (n, n))
    wu = rng.standard_normal(lead + (m, m))
    exp = (rng.standard_normal(lead + (n,)), rng.standard_normal(lead + (m,)),
           0.1 * w @ tr(w) + 0.1 * np.eye(n), 0.1 * wu @ tr(wu) + np.eye(m), 0.1 * rng.standard_normal(lead + (m, n)))
    wf = rng.standard_normal(tuple(batch) + (n, n))
    return a, b, exp, rng.standard_normal(tuple(batch) + (n,)), wf @ tr(wf) + np.eye(n)


def to_torch(a, b, exp, v_x, v_xx):
    t = torch.from_numpy
    return t(a), t(b), CostExpansion(*(t(e) for e in exp)), t(v_x), t(v_xx)


def to_jax(a, b, exp, v_x, v_xx):
    j = jnp.asarray
    return j(a), j(b), JCostExpansion(*(j(e) for e in exp)), j(v_x), j(v_xx)


def close(out, ref, rtol=RTOL, atol=ATOL):
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol, atol=atol)


def random_elements(seed, lead=(3, 5), n=6):
    """Two stacks of valid value elements (C, J PSD), as numpy field tuples."""
    rng = np.random.default_rng(seed)

    def element():
        wc, wj = rng.standard_normal(lead + (n, n)), rng.standard_normal(lead + (n, n))
        return (np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n)), rng.standard_normal(lead + (n,)),
                0.2 * wc @ np.swapaxes(wc, -1, -2), rng.standard_normal(lead + (n,)),
                0.2 * wj @ np.swapaxes(wj, -1, -2) + np.eye(n))

    return element(), element()


def test_combine_matches_jax():
    earlier, later = random_elements(1)
    out = tric._combine(tric.ValueElement(*map(torch.from_numpy, earlier)),
                        tric.ValueElement(*map(torch.from_numpy, later)))
    ref = jric._combine(jric.ValueElement(*map(jnp.asarray, earlier)), jric.ValueElement(*map(jnp.asarray, later)))
    close(out, ref)


@pytest.mark.parametrize("reg", [1e-6, 0.3])
def test_stage_elements_match_jax(reg):
    data = random_lq(9, seed=2)
    out, b_out, p_out = tric._stage_elements_with_factors(*to_torch(*data)[:3], reg)
    ref, b_ref, p_ref = jric._stage_elements_with_factors(*to_jax(*data)[:3], reg)
    close(out, ref)
    close((b_out, p_out), (b_ref, p_ref))
    close(tric._stage_elements(*to_torch(*data)[:3], reg), ref)


def test_combine_stage_acc_equals_combine():
    """The Woodbury fold is exact algebra: equal to the generic combine, and to JAX's fold."""
    data = random_lq(6, seed=3)
    stage, b_mat, p_mat = tric._stage_elements_with_factors(*to_torch(*data)[:3], 1e-6)
    jstage, jb, jp = jric._stage_elements_with_factors(*to_jax(*data)[:3], 1e-6)
    # An accumulated element: the suffix of the last stages composed with the terminal element.
    acc = tric._combine(tric.ValueElement(*(f[1:] for f in stage)),
                        tric._terminal_element(*(x.expand((5,) + x.shape) for x in to_torch(*data)[3:])))
    jacc = jric.ValueElement(*(jnp.asarray(f.numpy()) for f in acc))
    first = tric.ValueElement(*(f[:-1] for f in stage))
    fold = tric._combine_stage_acc(first, b_mat[:-1], p_mat[:-1], acc)
    close(fold, tric._combine(first, acc), rtol=1e-9, atol=1e-10)
    jfirst = jric.ValueElement(*(f[:-1] for f in jstage))
    close(fold, jric._combine_stage_acc(jfirst, jb[:-1], jp[:-1], jacc))


@pytest.mark.parametrize("horizon", [1, 2, 3, 30, 1024])
def test_suffix_value_functions_and_gains_match_jax(horizon):
    """Odd lengths and non-powers of two are where a hand-written scan goes wrong.

    JAX's associative pass (jitted: one compile per shape) returns the suffix
    value functions and the gains; the port's ``suffix_value_functions`` and
    ``riccati_backward_associative`` are held to both.
    """
    n, m = (12, 4) if horizon < 30 else (4, 2)
    data = random_lq(horizon, n, m, seed=horizon)
    ref = jax.jit(jric.riccati_backward_associative)(*to_jax(*data), 1e-6)
    suffix = tric.suffix_value_functions(*to_torch(*data), 1e-6)
    assert suffix[0].shape == (horizon + 1, n) and suffix[1].shape == (horizon + 1, n, n)
    close(suffix, (ref.v_x_seq, ref.v_xx_seq))
    _build.reset_launches()
    close(tric.riccati_backward_associative(*to_torch(*data), 1e-6), ref)
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel


def test_riccati_backward_associative_with_lu_gains_matches_jax():
    """``use_chol=False``: the gains from a library LU solve on both sides."""
    data = random_lq(5, seed=5)
    ref = jax.jit(jric.riccati_backward_associative, static_argnums=6)(*to_jax(*data), 0.3, False)
    close(tric.riccati_backward_associative(*to_torch(*data), 0.3, False), ref)


def test_batched_associative_equals_a_loop_over_lanes():
    """Leading batch axes and a per-lane reg tensor: each lane is the single-trajectory pass."""
    data = to_torch(*random_lq(17, seed=6, batch=(3,)))
    reg = torch.tensor([1e-6, 1e-2, 1.0], dtype=torch.float64)
    out = tric.riccati_backward_associative(*data, reg)
    a, b, exp, v_x, v_xx = data
    for lane in range(3):
        single = tric.riccati_backward_associative(a[lane], b[lane], CostExpansion(*(e[lane] for e in exp)),
                                                   v_x[lane], v_xx[lane], float(reg[lane]))
        for o, s in zip(out, single):
            np.testing.assert_allclose(o[lane].numpy(), s.numpy(), rtol=1e-12, atol=1e-13)


def test_riccati_backward_segment_matches_jax():
    data = random_lq(12, seed=7)
    out = tric.riccati_backward_segment(*to_torch(*data), window=5)
    ref = jric.riccati_backward_segment(*to_jax(*data), window=5)
    close(out, ref)
    assert out.k_seq.shape == (5, 4)


def test_auto_takes_jax_branch_on_cpu():
    """``tests/test_riccati.py::test_auto_dispatch_matches_both_forms`` on the port."""
    data = to_torch(*random_lq(40, 6, 2, seed=0))
    seq = tric.riccati_backward(*data)
    batched = tric.riccati_backward_auto(*data, batch_size=64)
    np.testing.assert_allclose(batched.k_seq.numpy(), seq.k_seq.numpy(), rtol=1e-12)
    data = to_torch(*random_lq(300, 6, 2, seed=0))
    seq = tric.riccati_backward(*data)
    auto = tric.riccati_backward_auto(*data, batch_size=1)
    assoc = tric.riccati_backward_associative(*data)
    np.testing.assert_allclose(auto.k_seq.numpy(), assoc.k_seq.numpy(), rtol=1e-12)
    np.testing.assert_allclose(auto.k_seq.numpy(), seq.k_seq.numpy(), rtol=1e-3, atol=1e-6)
    short = tric.riccati_backward_auto(*to_torch(*random_lq(300, 6, 2, seed=0)), latency_crossover_h=301)
    np.testing.assert_allclose(short.k_seq.numpy(), seq.k_seq.numpy(), rtol=1e-12)
