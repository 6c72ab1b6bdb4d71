"""Port parity: ``batched_ilqr_solve`` against quattro_tpu's, backend by backend.

The problems are the JAX tests' cart-pole batches (``tests/test_fused_riccati.py``,
``tests/test_fused_rollout.py``, ``tests/test_parallel.py``), float64, initial
states from a numpy seed. The JAX side runs its fused backends with the Pallas
kernels in interpret mode; the port runs the kernels' plain forms (CPU
tensors). Iterations and convergence flags must be equal; x, u and cost rtol
1e-8, gains 1e-7 on their scale (the tolerances of the single solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import parallel as jparallel
from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.parallel.batch import _fused_backend_applies as j_fused_backend_applies
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.parallel import batch as tbatch
from quattro_tpu_torch.parallel import batched_ilqr_solve

RTOL = 1e-8
GAIN_TOL = 1e-7


def cartpole(x0s, horizon, dtype=np.float64):
    """(jax args, torch args): dyn, cost, fcost, x0 batch, zero controls."""
    q, r, qf = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
    x0s = np.asarray(x0s, dtype=dtype)
    u0s = np.zeros((x0s.shape[0], horizon, 1), dtype=dtype)
    j = (jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4"),
         jsolver.make_quadratic_cost(jnp.asarray(q, dtype), jnp.asarray(r, dtype), jnp.zeros(4, dtype)),
         jsolver.make_quadratic_final_cost(jnp.asarray(qf, dtype), jnp.zeros(4, dtype)),
         jnp.asarray(x0s), jnp.asarray(u0s))
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=dtype))
    tp = (tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
          tsolver.make_quadratic_cost(t(q), t(r), t(np.zeros(4))),
          tsolver.make_quadratic_final_cost(t(qf), t(np.zeros(4))),
          t(x0s), t(u0s))
    return j, tp


def seeded_x0(batch, scale, seed):
    return scale * np.random.default_rng(seed).standard_normal((batch, 4))


def assert_same_solve(ref, got, rtol=RTOL, gain_tol=GAIN_TOL):
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for name in ("x_seq", "u_seq", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=rtol,
                                   atol=rtol * float(np.abs(np.asarray(getattr(ref, name))).max()))
    for name in ("k_seq", "big_k_seq"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0, atol=gain_tol * max(np.abs(r).max(), 1.0))


@pytest.mark.parametrize("backend", ["vmap", "fused"])
def test_backends_match_jax(backend):
    """``tests/test_fused_riccati.py``'s batched problem: B=6, H=20, tol 0.1, up to 12 iterations."""
    jprob, tprob = cartpole(seeded_x0(6, 0.3, 0), 20)
    cfg = dict(tol=1e-1, max_iter=12)
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**cfg), riccati_backend=backend)
    _build.reset_launches()
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend=backend)
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert got.iterations.dtype == torch.int32 and got.converged.dtype == torch.bool
    assert_same_solve(ref, got)


def test_fused_backend_with_fused_line_search_matches_jax():
    """``tests/test_fused_rollout.py``'s problem: B=3, H=10, linesearch="fused" (K7's plain form)."""
    jprob, tprob = cartpole(seeded_x0(3, 0.2, 4), 10)
    cfg = dict(tol=1e-1, max_iter=4, linesearch="fused")
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**cfg), riccati_backend="fused")
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend="fused")
    assert_same_solve(ref, got)


def test_auto_matches_jax_and_single_solves():
    """``tests/test_parallel.py``'s problem: B=2, H=30; "auto" on the CPU is the vmap backend."""
    jprob, tprob = cartpole([[0.2, 0.0, 0.3, 0.0], [-0.1, 0.0, -0.2, 0.0]], 30)
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(tol=1e-1))
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(tol=1e-1))
    assert_same_solve(ref, got)
    for lane in range(2):
        single = tsolver.ilqr_solve(*tprob[:3], tprob[3][lane], tprob[4][lane], tsolver.ILQRConfig(tol=1e-1))
        np.testing.assert_allclose(float(got.cost[lane]), float(single.cost), rtol=1e-10)


def test_fused_bf16_backend_matches_jax():
    """The bfloat16 stream in float64 data: the same rounding of the stage inputs on both sides."""
    jprob, tprob = cartpole([[0.2, 0, 0.3, 0], [-0.1, 0, -0.2, 0]], 12)
    cfg = dict(tol=1e-12, max_iter=2)
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**cfg), riccati_backend="fused_bf16")
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend="fused_bf16")
    assert_same_solve(ref, got)
    exact = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend="fused")
    rel = ((got.cost - exact.cost).abs() / exact.cost.abs()).max()
    assert 0.0 < float(rel) < 0.05  # quantized, and within JAX's band of the exact backend


def test_vmap_backend_adaptive_reg_matches_jax():
    """Per-lane reg: JAX carries the LM mu-schedule per lane under vmap."""
    jprob, tprob = cartpole(seeded_x0(3, 0.3, 7), 10)
    cfg = dict(tol=1e-2, max_iter=6, adaptive_reg=True, reg=1e-3)
    ref = jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**cfg), riccati_backend="vmap")
    got = batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**cfg), riccati_backend="vmap")
    assert_same_solve(ref, got)


@pytest.mark.parametrize(
    "config,backend,match",
    [
        (dict(), "warp", "riccati_backend"),
        (dict(adaptive_reg=True), "fused", "adaptive"),
        (dict(adaptive_reg=True), "fused_bf16", "adaptive"),
        (dict(riccati="seq"), "fused", "pinned"),
        (dict(parallel_riccati=True), "fused_bf16", "pinned"),
        (dict(riccati="fused", adaptive_reg=True), "vmap", "adaptive"),
    ],
    ids=["unknown", "fused-adaptive", "bf16-adaptive", "fused-pinned", "bf16-pinned", "vmap-fused-adaptive"],
)
def test_guards_raise_as_in_jax(config, backend, match):
    jprob, tprob = cartpole(np.zeros((2, 4)), 10)
    with pytest.raises(ValueError, match=match):
        batched_ilqr_solve(*tprob, tsolver.ILQRConfig(**config), riccati_backend=backend)
    if backend != "vmap":  # JAX raises the same guards (its vmap case raises at trace time too)
        with pytest.raises(ValueError):
            jparallel.batched_ilqr_solve(*jprob, jsolver.ILQRConfig(**config), riccati_backend=backend)


def test_fused_guard_on_wide_plants():
    x0 = torch.zeros(2, 17, dtype=torch.float64)
    u0 = torch.zeros(2, 5, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="n <= 16"):
        batched_ilqr_solve(None, None, None, x0, u0, riccati_backend="fused")


def test_fused_backend_applies_like_jax(monkeypatch):
    """``tests/test_fused_riccati.py::test_auto_dispatch_respects_pinned_algorithm`` with CUDA for the TPU."""
    x0, u0 = np.zeros((16, 4), np.float32), np.zeros((16, 10, 1), np.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cases = [dict(), dict(riccati="assoc"), dict(riccati="seq"), dict(parallel_riccati=True),
             dict(linesearch="fused"), dict(adaptive_reg=True)]
    for case in cases:
        want = j_fused_backend_applies(jsolver.ILQRConfig(**case), jnp.asarray(x0), jnp.asarray(u0))
        got = tbatch._fused_backend_applies(tsolver.ILQRConfig(**case), torch.from_numpy(x0), torch.from_numpy(u0),
                                            device_type="cuda")
        assert got == want, case
    assert [case for case in cases if j_fused_backend_applies(
        jsolver.ILQRConfig(**case), jnp.asarray(x0), jnp.asarray(u0))] == [dict(), dict(linesearch="fused")]
    # The batch's own device decides by default; float64 and narrow batches stay on "vmap".
    t = torch.from_numpy
    assert not tbatch._fused_backend_applies(tsolver.ILQRConfig(), t(x0), t(u0))
    assert not tbatch._fused_backend_applies(tsolver.ILQRConfig(), t(x0).double(), t(u0).double(), "cuda")
    assert not tbatch._fused_backend_applies(tsolver.ILQRConfig(), t(x0[:4]), t(u0[:4]), "cuda")


def test_bf16_stream_never_auto_selected(monkeypatch):
    """Only riccati_backend="fused_bf16" streams bfloat16; "auto" takes the exact kernel."""
    streams = []
    real = tbatch.riccati_backward_batched_fused_auto

    def spy(*args, stream_dtype=None, **kwargs):
        streams.append(stream_dtype)
        return real(*args, stream_dtype=stream_dtype, **kwargs)

    monkeypatch.setattr(tbatch, "riccati_backward_batched_fused_auto", spy)
    monkeypatch.setattr(tbatch, "_fused_backend_applies", lambda *a, **k: True)
    _, tprob = cartpole(np.zeros((2, 4)) + 0.1, 6)
    batched_ilqr_solve(*tprob, tsolver.ILQRConfig(max_iter=1))
    batched_ilqr_solve(*tprob, tsolver.ILQRConfig(max_iter=1), riccati_backend="fused_bf16")
    assert streams == [None, torch.bfloat16]
