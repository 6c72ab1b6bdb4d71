"""Port parity: the iLQR solves (pure and hybrid) against quattro_tpu.

The bench.py problem (quadrotor RK4 hover, barrier cost) cut to H=16 with
3 forced iterations (tol=0), float64, rtol 1e-8 on x, u and cost; the
iteration count must match exactly.
"""

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
from quattro_tpu.solver.ilqr import pack_gain_tokens as j_pack_gain_tokens
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.models import DataNormalizer, GainPredictor
from quattro_tpu_torch.ops import _build

H = 16
RTOL = 1e-8
ATOL = 1e-10
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


def bench_problem(horizon=H):
    """bench.py's problem in both packages: (jax tuple, torch tuple), each (dyn, cost, fcost, x0, u0)."""
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    x0 = np.zeros(12)
    x0[2], x0[6] = 0.2, 0.1
    u0 = np.zeros((horizon, 4))
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


def _close_solution(ref, out, gain_tol=None):
    assert int(out.iterations) == int(ref.iterations)
    assert bool(out.converged) == bool(ref.converged)
    for name in ("x_seq", "u_seq", "cost", "k_seq", "big_k_seq"):
        expected = np.asarray(getattr(ref, name))
        rtol, atol = RTOL, ATOL
        if gain_tol is not None and name in ("k_seq", "big_k_seq"):
            rtol, atol = gain_tol, gain_tol * np.abs(expected).max()
        np.testing.assert_allclose(getattr(out, name).numpy(), expected, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize(
    "options",
    [
        dict(riccati="seq"),
        dict(riccati="fused", linesearch="fused"),
        dict(riccati="seq", adaptive_reg=True),
        dict(riccati="seq", linesearch_fuse_cost=True),
    ],
    ids=["seq-xla", "fused-fused", "adaptive-reg", "fuse-cost"],
)
def test_ilqr_solve_matches_jax(options):
    jprob, tprob, _ = bench_problem()
    ref = jsolver.ilqr_solve(*jprob, jsolver.ILQRConfig(tol=0.0, max_iter=3, **options))
    _build.reset_launches()
    out = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(tol=0.0, max_iter=3, **options))
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert int(out.iterations) == 3
    _close_solution(ref, out)


def test_ilqr_solve_early_exit_matches_jax():
    """A loose tol ends the solve on |dJ| < tol, in the same iteration as JAX."""
    jprob, tprob, _ = bench_problem()
    ref = jsolver.ilqr_solve(*jprob, jsolver.ILQRConfig(tol=1.0, max_iter=20, riccati="seq"))
    out = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(tol=1.0, max_iter=20, riccati="seq"))
    assert bool(out.converged) and int(out.iterations) < 20
    _close_solution(ref, out)


@pytest.mark.parametrize(
    "probe",
    [
        lambda c: c(riccati="warp"),
        lambda c: c(linesearch="warp"),
        lambda c: c()._replace(riccati="warp"),
        lambda c: c()._replace(linesearch="warp"),
        lambda c: c(linesearch="fused", linesearch_unroll=4),
        lambda c: c(linesearch="fused", linesearch_fuse_cost=True),
    ],
    ids=["riccati", "linesearch", "replace-riccati", "replace-linesearch", "fused-unroll", "fused-fuse-cost"],
)
def test_ilqr_config_fails_fast_like_jax(probe):
    with pytest.raises(ValueError):
        probe(jsolver.ILQRConfig)
    with pytest.raises(ValueError):
        probe(tsolver.ILQRConfig)


def test_ilqr_config_defaults_match_jax():
    assert tsolver.ILQRConfig._fields == jsolver.ILQRConfig._fields
    assert tuple(tsolver.ILQRConfig()) == tuple(jsolver.ILQRConfig())


def test_unported_solver_forms_name_their_roadmap_item():
    """The last solver form that was not ported, ``riccati="assoc"``, now solves: held to
    JAX's associative-scan solve with the early exit (tol 1.0), as the other modes are."""
    jprob, tprob, _ = bench_problem()
    ref = jsolver.ilqr_solve(*jprob, jsolver.ILQRConfig(tol=1.0, max_iter=20, riccati="assoc"))
    _build.reset_launches()
    out = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(tol=1.0, max_iter=20, riccati="assoc"))
    assert sum(_build.launches.values()) == 0
    assert bool(out.converged) and int(out.iterations) < 20
    _close_solution(ref, out, gain_tol=1e-7)


@pytest.mark.parametrize(
    "options",
    [dict(tol=0.0, max_iter=3), dict(tol=1.0, max_iter=12), dict(tol=0.0, max_iter=3, adaptive_reg=True)],
    ids=["forced", "early-exit", "adaptive-reg"],
)
def test_ilqr_solve_with_logs_matches_jax(options):
    """The solution and every log buffer, rtol 1e-8; rows past ``iterations`` stay zero and invalid."""
    jprob, tprob, _ = bench_problem()
    ref, ref_logs = jsolver.ilqr_solve_with_logs(*jprob, jsolver.ILQRConfig(riccati="seq", **options))
    out, logs = tsolver.ilqr_solve_with_logs(*tprob, tsolver.ILQRConfig(riccati="seq", **options))
    _close_solution(ref, out)
    assert logs._fields == ref_logs._fields
    for name in logs._fields:
        got, expected = getattr(logs, name).numpy(), np.asarray(getattr(ref_logs, name))
        assert got.shape == expected.shape and got.dtype == expected.dtype, name
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=name)
    assert logs.valid.sum() == out.iterations
    if options["tol"] > 0.0:
        assert out.iterations < options["max_iter"] and not logs.x_seq[out.iterations:].any()


def test_ilqr_solve_with_logs_agrees_with_ilqr_solve():
    _, tprob, _ = bench_problem()
    cfg = tsolver.ILQRConfig(tol=1.0, max_iter=12, riccati="seq")
    ref = tsolver.ilqr_solve(*tprob, cfg)
    out, logs = tsolver.ilqr_solve_with_logs(*tprob, cfg)
    assert out.iterations == ref.iterations and out.converged == ref.converged
    for name in ("x_seq", "u_seq", "cost", "k_seq", "big_k_seq"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(ref, name).numpy())
    np.testing.assert_array_equal(logs.new_cost[out.iterations - 1].numpy(), out.cost.numpy())


def test_gain_tokens_round_trip_like_jax():
    rng = np.random.default_rng(0)
    k, big_k = rng.standard_normal((5, 4)), rng.standard_normal((5, 4, 12))
    ref = j_pack_gain_tokens(jnp.asarray(k), jnp.asarray(big_k))
    out = tsolver.pack_gain_tokens(torch.from_numpy(k), torch.from_numpy(big_k))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    k2, big_k2 = tsolver.unpack_gain_tokens(out, 4, 12)
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(big_k2.numpy(), big_k)


def float32_params(jpred):
    """The predictor with float32 weights, as it is made and saved without x64.

    Under the tests' x64 setting flax draws ``target_embedding`` in float64;
    the port's parameters are float32, so both sides get float32 weights.
    """
    return dataclasses.replace(jpred, params=jax.tree.map(lambda p: p.astype(jnp.float32), jpred.params))


def small_predictors(prompt_len, target_len, seed=0):
    """A small random JAX predictor and the same weights in the port (params_from_jax)."""
    rng = np.random.default_rng(seed)
    control_dim = 4 * 13
    x_mean, x_std = 0.1 * rng.standard_normal(12), 1.0 + 0.1 * rng.random(12)
    u_mean, u_std = 0.1 * rng.standard_normal(control_dim), 1.0 + 0.1 * rng.random(control_dim)
    jnorm = JDataNormalizer(*(jnp.asarray(v, dtype=jnp.float32) for v in (x_mean, x_std, u_mean, u_std)))
    hparams = dict(
        state_dim=12, control_dim=control_dim, d_model=16, nhead=2, num_decoder_layers=1,
        dim_feedforward=32, dropout=0.0, max_seq_len=64, target_len=target_len, prompt_len=prompt_len,
    )
    jpred = JGainPredictor.create(
        12, control_dim, prompt_len, target_len, d_model=16, nhead=2, num_decoder_layers=1,
        dim_feedforward=32, dropout=0.0, max_seq_len=64, rng=jax.random.PRNGKey(seed), normalizer=jnorm,
    )
    jpred = float32_params(jpred)
    tnorm = DataNormalizer(*(torch.tensor(v, dtype=torch.float32) for v in (x_mean, x_std, u_mean, u_std)))
    tpred = GainPredictor.from_flat(hparams, _flatten_params(jpred.params), tnorm, device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("exact_fallback", [False, True])
def test_hybrid_ilqr_solve_matches_jax(exact_fallback):
    window = 4
    jprob, tprob, x_ref = bench_problem()
    jpred, tpred = small_predictors(window, H - window)
    offset = x_ref.copy()
    ref = jsolver.hybrid_ilqr_solve(
        *jprob[:3], jpred.predict_fn(), window, *jprob[3:], jnp.asarray(x_ref),
        jsolver.ILQRConfig(tol=0.0, max_iter=3, riccati="seq"), jnp.asarray(offset), exact_fallback=exact_fallback,
    )
    out = tsolver.hybrid_ilqr_solve(
        *tprob[:3], tpred.predict_fn(), window, *tprob[3:], torch.from_numpy(x_ref),
        tsolver.ILQRConfig(tol=0.0, max_iter=3, riccati="seq"), torch.from_numpy(offset), exact_fallback=exact_fallback,
    )
    # The predicted head gains are float32 in both packages. Inside the JAX
    # while_loop XLA contracts the de-normalizing u * std + mean into one FMA
    # (the JAX predictor jitted and eager already differ by an ulp there), so
    # the gains are held to a few float32 ulps of their scale.
    _close_solution(ref, out, gain_tol=4 * float(np.finfo(np.float32).eps))
