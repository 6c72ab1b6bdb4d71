"""Port parity: ``batched_hybrid_ilqr_solve`` against ``jax.vmap(hybrid_ilqr_solve)``.

The problem is ``tests/test_torch_ilqr.py``'s (the bench.py quadrotor, RK4,
barrier cost) at H=24 with a window of 4, B=4 lanes from a numpy seed, one of
them starting at the hover it is asked to hold (it finishes after one
iteration), ``max_iter`` 3, float64. The predictor is a small random one with
``state_stride`` 2, its weights carried across by ``params_from_jax``.

Against JAX both sides run a float64 stand-in of that predictor (its forward
in float64, without the float32 round of ``predict_fn``: two frameworks'
float64 forwards about 1e-15 apart can land one float32 ulp apart, which
moves u by far more than the tolerance). Iterations and flags must be equal,
cost rtol 1e-9, u atol 1e-8 (``tests/test_fused_riccati.py``'s tolerances
for two backends of one batched solve); x likewise, the gains on their scale.

An 18-state linear system (beyond K4's n <= 16) checks that the tail then
runs the sequential pass under ``vmap``, against JAX at the same tolerances.

Within the port each lane of the batched solve is held to the port's own
``hybrid_ilqr_solve`` of that lane at the same tolerances, with the real
``predict_fn``; and the batched ``predict_fn`` to B unbatched calls.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.models import DataNormalizer as JDataNormalizer
from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.models import DataNormalizer, GainPredictor
from quattro_tpu_torch.ops import _build
from quattro_tpu_torch.parallel import batch as batch_module
from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve

H, WINDOW, STRIDE, BATCH, MAX_ITER = 24, 4, 2, 4, 3
TOL = 1e-4
COST_RTOL, U_ATOL, GAIN_TOL = 1e-9, 1e-8, 1e-7
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]
HOVER = 2.4525  # thrust per rotor that holds the nominal quadrotor still


def problem(seed=3):
    """(jax tuple, torch tuple), each (dyn, cost, fcost, x0 (B, n), u0 (B, H, m)), and x_ref.

    Lanes 1..B-1 start below the reference with a tilt, from zero thrust; lane 0
    starts at the reference with hover thrust, a few steps from its optimum."""
    rng = np.random.default_rng(seed)
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    x0 = np.zeros((BATCH, 12))
    x0[:, 2] = 0.2 + 0.3 * rng.random(BATCH)
    x0[:, 6] = 0.1 * rng.standard_normal(BATCH)
    x0[0] = x_ref
    u0 = np.zeros((BATCH, H, 4))
    u0[0] = HOVER
    jprob = (
        jsystems.make_discrete(jsystems.quadrotor_dynamics, 0.01, "rk4"),
        jsolver.make_quadratic_cost(jnp.asarray(Q), jnp.full((4,), 0.01), jnp.asarray(x_ref), barrier_alpha=1000.0),
        jsolver.make_quadratic_final_cost(jnp.asarray(QF), jnp.asarray(x_ref)),
        jnp.asarray(x0),
        jnp.asarray(u0),
    )
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    tprob = (
        tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4"),
        tsolver.make_quadratic_cost(t(Q), torch.full((4,), 0.01, dtype=torch.float64), t(x_ref), barrier_alpha=1000.0),
        tsolver.make_quadratic_final_cost(t(QF), t(x_ref)),
        t(x0),
        t(u0),
    )
    return jprob, tprob, x_ref


def predictors(gain_scale=1.0, seed=0, n=12, m=4, horizon=H, window=WINDOW):
    """A small random JAX predictor with state_stride 2 and the same weights in the port.

    ``gain_scale`` scales the normalizer's gain statistics: at 1 the head gains
    are random and no hybrid step of the far lanes is accepted; at 1e-3 they
    are nearly zero, the head keeps its controls and the exact tail improves
    them, so hybrid steps are accepted."""
    rng = np.random.default_rng(seed)
    control_dim = m * (1 + n)
    stats = (0.1 * rng.standard_normal(n), 1.0 + 0.1 * rng.random(n),
             0.1 * gain_scale * rng.standard_normal(control_dim), gain_scale * (1.0 + 0.1 * rng.random(control_dim)))
    hparams = dict(state_dim=n, control_dim=control_dim, d_model=16, nhead=2, num_decoder_layers=1,
                   dim_feedforward=32, dropout=0.0, max_seq_len=64, target_len=horizon - window, prompt_len=window)
    jpred = JGainPredictor.create(
        n, control_dim, window, horizon - window, d_model=16, nhead=2, num_decoder_layers=1, dim_feedforward=32,
        dropout=0.0, max_seq_len=64, rng=jax.random.PRNGKey(seed),
        normalizer=JDataNormalizer(*(jnp.asarray(v, dtype=jnp.float32) for v in stats)), state_stride=STRIDE,
    )
    # Under the tests' x64 setting flax draws some weights in float64; the port's are float32.
    jpred = dataclasses.replace(jpred, params=jax.tree.map(lambda p: p.astype(jnp.float32), jpred.params))
    tnorm = DataNormalizer(*(torch.tensor(v, dtype=torch.float32) for v in stats))
    tpred = GainPredictor.from_flat(hparams, _flatten_params(jpred.params), tnorm, STRIDE, device="cpu")
    return jpred, tpred


def jax_float64_stand_in(jpred, window=WINDOW):
    """``jpred.predict_fn()`` computed in float64 throughout, for one lane."""
    params = jax.tree.map(lambda p: p.astype(jnp.float64), jpred.params)
    norm = JDataNormalizer(*(jnp.asarray(v, jnp.float64) for v in jpred.normalizer))

    def predict(x_err, kk):
        x = norm.transform_x(x_err[::STRIDE])[None]
        prompt = norm.transform_u(kk)[-window:][None]
        return norm.inverse_transform_u(jpred.module.apply({"params": params}, x, prompt, deterministic=True)[0])

    return predict


def port_float64_stand_in(tpred, window=WINDOW):
    """``tpred.predict_fn()`` computed in float64 throughout, over a batch."""
    module = copy.deepcopy(tpred.module).double()
    norm = DataNormalizer(*(v.double() for v in tpred.normalizer))

    @torch.no_grad()
    def predict(x_err, kk):
        out = module(norm.transform_x(x_err[:, ::STRIDE]), norm.transform_u(kk)[:, -window:])
        return norm.inverse_transform_u(out)

    return predict


def assert_lanes_equal(ref, got):
    """Iterations and flags equal; cost rtol 1e-9; x, u atol 1e-8; gains on their scale."""
    np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(ref.iterations))
    np.testing.assert_array_equal(np.asarray(got.converged), np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=COST_RTOL, atol=0)
    for name in ("x_seq", "u_seq"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)), rtol=0,
                                   atol=U_ATOL)
    for name in ("k_seq", "big_k_seq"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(np.asarray(getattr(got, name)), r, rtol=0, atol=GAIN_TOL * max(np.abs(r).max(), 1))


@pytest.mark.parametrize("exact_fallback,gain_scale", [(False, 1e-3), (True, 1.0)])
def test_matches_jax_vmap(exact_fallback, gain_scale):
    """The batched solve against ``jax.vmap(hybrid_ilqr_solve)``, ``state_offset`` given, ``riccati="seq"``
    (the JAX suite's hybrid config: the fallback's exact pass is the sequential law on both sides). With the
    fallback and random head gains, every trip's far lanes take the exact iteration, a gathered subset."""
    jprob, tprob, x_ref = problem()
    jpred, tpred = predictors(gain_scale)
    offset = x_ref.copy()
    jcfg = jsolver.ILQRConfig(tol=TOL, max_iter=MAX_ITER, riccati="seq")
    jpredict = jax_float64_stand_in(jpred)
    ref = jax.vmap(lambda x, u: jsolver.hybrid_ilqr_solve(
        *jprob[:3], jpredict, WINDOW, x, u, jnp.asarray(x_ref), jcfg, jnp.asarray(offset),
        exact_fallback=exact_fallback))(*jprob[3:])
    _build.reset_launches()
    got = batched_hybrid_ilqr_solve(
        *tprob[:3], port_float64_stand_in(tpred), WINDOW, *tprob[3:], torch.from_numpy(x_ref),
        tsolver.ILQRConfig(tol=TOL, max_iter=MAX_ITER, riccati="seq"), torch.from_numpy(offset),
        exact_fallback=exact_fallback)
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert got.iterations.dtype == torch.int32 and got.x_seq.shape == (BATCH, H + 1, 12)
    its = np.asarray(ref.iterations)
    assert its[0] < MAX_ITER and its[1:].min() == MAX_ITER  # lane 0 finished early, the others ran on
    assert_lanes_equal(ref, got)


def wide_problem(n=18, m=2, horizon=12, batch=3, seed=7):
    """(jax tuple, torch tuple), each (dyn, cost, fcost, x0 (B, n), u0 (B, H, m)), and x_ref: a random stable
    linear system with n = 18 > 16 states (K4's limit), from a numpy seed."""
    rng = np.random.default_rng(seed)
    a = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    b = 0.1 * rng.standard_normal((n, m))
    x_ref = 0.1 * rng.standard_normal(n)
    x0 = rng.standard_normal((batch, n))
    u0 = np.zeros((batch, horizon, m))
    q, r, qf = np.ones(n), np.full(m, 0.1), np.full(n, 10.0)
    ja, jb, jx_ref = jnp.asarray(a), jnp.asarray(b), jnp.asarray(x_ref)
    jprob = (lambda x, u: ja @ x + jb @ u, jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jx_ref),
             jsolver.make_quadratic_final_cost(jnp.asarray(qf), jx_ref), jnp.asarray(x0), jnp.asarray(u0))
    t = torch.from_numpy
    ta, tb, tx_ref = t(a), t(b), t(x_ref)
    tprob = (lambda x, u: ta @ x + tb @ u, tsolver.make_quadratic_cost(t(q), t(r), tx_ref),
             tsolver.make_quadratic_final_cost(t(qf), tx_ref), t(x0), t(u0))
    return jprob, tprob, x_ref


@pytest.mark.parametrize("exact_fallback", [False, True])
def test_wide_state_tail_runs_the_sequential_pass(exact_fallback, monkeypatch):
    """n = 18 > 16: the tail window is out of K4's reach, so it runs the sequential pass under ``vmap`` (K4's
    plain form is never called), and the solve still matches ``jax.vmap(hybrid_ilqr_solve)``."""
    n, m, horizon, window = 18, 2, 12, 3
    jprob, tprob, x_ref = wide_problem(n, m, horizon)
    jpred, tpred = predictors(1e-3, n=n, m=m, horizon=horizon, window=window)
    jcfg = jsolver.ILQRConfig(tol=TOL, max_iter=MAX_ITER, riccati="seq")
    ref = jax.vmap(lambda x, u: jsolver.hybrid_ilqr_solve(
        *jprob[:3], jax_float64_stand_in(jpred, window), window, x, u, jnp.asarray(x_ref), jcfg,
        exact_fallback=exact_fallback))(*jprob[3:])

    def refused(*args, **kwargs):
        raise AssertionError("the tail pass reached K4 at n > 16")

    monkeypatch.setattr(batch_module, "riccati_backward_batched_fused_auto", refused)
    got = batched_hybrid_ilqr_solve(
        *tprob[:3], port_float64_stand_in(tpred, window), window, *tprob[3:], torch.from_numpy(x_ref),
        tsolver.ILQRConfig(tol=TOL, max_iter=MAX_ITER, riccati="seq"), exact_fallback=exact_fallback,
        riccati_backend="vmap")
    assert got.x_seq.shape == (3, horizon + 1, n)
    assert_lanes_equal(ref, got)


def single_solves(tprob, predict_fn, x_ref, config, offset, exact_fallback):
    """The port's ``hybrid_ilqr_solve`` of each lane, stacked."""
    sols = [tsolver.hybrid_ilqr_solve(*tprob[:3], predict_fn, WINDOW, tprob[3][b], tprob[4][b], x_ref, config,
                                      offset, exact_fallback=exact_fallback) for b in range(BATCH)]
    return tsolver.ILQRSolution(*(torch.stack([torch.as_tensor(getattr(s, f)) for s in sols])
                                  for f in tsolver.ILQRSolution._fields))


@pytest.mark.parametrize("exact_fallback,gain_scale,linesearch,offset", [
    (False, 1e-3, "xla", True), (True, 1.0, "xla", False), (True, 1e-3, "fused", True)])
def test_lanes_are_the_single_solves(exact_fallback, gain_scale, linesearch, offset):
    """Each lane, with the real ``predict_fn``, against the port's single hybrid solve of that lane. With
    ``linesearch="fused"`` the batch runs K7's plain form and the singles K2's."""
    _, tprob, x_ref = problem()
    _, tpred = predictors(gain_scale)
    x_ref = torch.from_numpy(x_ref)
    state_offset = x_ref.clone() if offset else None
    config = tsolver.ILQRConfig(tol=TOL, max_iter=MAX_ITER, riccati="seq", linesearch=linesearch)
    got = batched_hybrid_ilqr_solve(*tprob[:3], tpred.predict_fn(), WINDOW, *tprob[3:], x_ref, config,
                                    state_offset, exact_fallback=exact_fallback)
    assert_lanes_equal(single_solves(tprob, tpred.predict_fn(), x_ref, config, state_offset, exact_fallback), got)


def test_batched_predict_fn_is_the_unbatched_calls():
    """``predict_fn`` over (B, T, n), (B, P', c) against B unbatched calls, float32 and float64 inputs: the same
    float32 outputs, within an ulp of their scale."""
    _, tpred = predictors()
    rng = np.random.default_rng(5)
    predict = tpred.predict_fn()
    for dtype in (torch.float32, torch.float64):
        x_err = torch.tensor(0.2 * rng.standard_normal((3, H + 1, 12)), dtype=dtype)
        kk = torch.tensor(rng.standard_normal((3, WINDOW + 2, 52)), dtype=dtype)
        out = predict(x_err, kk)
        assert out.shape == (3, H - WINDOW, 52) and out.dtype == torch.float32
        ref = torch.stack([predict(x_err[b], kk[b]) for b in range(3)])
        scale = float(ref.abs().max())
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=float(np.finfo(np.float32).eps) * scale)


def test_unknown_backend_raises():
    _, tprob, x_ref = problem()
    _, tpred = predictors()
    with pytest.raises(ValueError, match="riccati_backend"):
        batched_hybrid_ilqr_solve(*tprob[:3], tpred.predict_fn(), WINDOW, *tprob[3:], torch.from_numpy(x_ref),
                                  riccati_backend="warp")
