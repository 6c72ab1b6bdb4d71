"""The batched solve's K5 route on the CPU: one K5 launch per trip feeding K4 in the packed layout.

On the K4 backends (``"fused"``, ``"fused_bf16"``) a trip's running stage
derivatives come from K5 (``ops/fused_linquad.py``) where K5 takes the
problem: dynamics with device code, a running cost of ``make_quadratic_cost``,
float32 or float64 data, a batch that is a multiple of ``default_tile_s(B) *
128``. On CPU tensors K5's and K4's plain forms run: the solver's own ``vmap``
derivatives, packed, then unpacked. So a solve on that route equals the
natural route's bit for bit, and the tests here hold the dispatch, the packed
path (with a pad step at an odd horizon) and the route's counter.

Everything else (an unaligned batch, a user plant or cost without device
code, the ``"vmap"`` backend, the batched hybrid solve) keeps the ``vmap``
derivatives: no K5 call, the same result as the natural route, no raise.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_cuda import harness
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.parallel import batch as tbatch
from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve, batched_ilqr_solve, batched_ilqr_solve_with_logs
from quattro_tpu_torch.utils import timing

Q_QUAD = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
HOVER = 2.4525  # thrust per rotor that holds the nominal quadrotor still
CONFIG = tsolver.ILQRConfig(tol=1e-6, max_iter=3, linesearch="fused")


def quadrotor(batch, horizon, seed=0):
    """The bench quadrotor (RK4, softplus^2 barrier), float64, seeded starts around the hover at z = 0.5."""
    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    x0 = np.tile(x_ref, (batch, 1))
    x0[:, :3] += 0.1 * rng.standard_normal((batch, 3))
    x0[:, 6:9] += 0.2 * rng.standard_normal((batch, 3))
    return (tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4"),
            tsolver.make_quadratic_cost(t(Q_QUAD), t([0.01] * 4), t(x_ref), barrier_alpha=1000.0),
            tsolver.make_quadratic_final_cost(t(10.0 * np.asarray(Q_QUAD)), t(x_ref)),
            t(x0), t(np.full((batch, horizon, 4), HOVER)))


def cartpole(batch, horizon, seed=0):
    """``tests/test_torch_batch.py``'s cart-pole, float64, seeded starts."""
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    x0 = 0.3 * np.random.default_rng(seed).standard_normal((batch, 4))
    return (tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
            tsolver.make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t(np.zeros(4))),
            tsolver.make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t(np.zeros(4))),
            t(x0), t(np.zeros((batch, horizon, 1))))


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.reset(timing.SPAN_CAPACITY)
    yield
    timing.tracing(None)
    timing.reset(timing.SPAN_CAPACITY)


@pytest.fixture
def k5_calls(monkeypatch):
    """Every call of K5 from the batched solve, by the batch width it was given."""
    calls = []
    real = tbatch.linquad_batched_fused

    def spy(dynamics, cost, xs, us, *args, **kwargs):
        calls.append(xs.shape[0])
        return real(dynamics, cost, xs, us, *args, **kwargs)

    monkeypatch.setattr(tbatch, "linquad_batched_fused", spy)
    return calls


@contextlib.contextmanager
def natural_route(monkeypatch):
    """The K5 route switched off inside the block: every trip takes the ``vmap`` derivatives."""
    with monkeypatch.context() as patch:
        patch.setattr(tbatch, "_linquad_applies", lambda *args: False)
        yield


def assert_bit_equal(got, ref):
    for name, a, b in zip(type(ref)._fields, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize(
    "plant, horizon, backend, logs",
    [("quadrotor", 10, "fused", False), ("cartpole", 9, "fused", False), ("quadrotor", 10, "fused_bf16", False),
     ("quadrotor", 10, "fused", True), ("cartpole", 9, "fused", True)],
    ids=["quadrotor", "cartpole-pad-step", "quadrotor-bf16", "quadrotor-logs", "cartpole-logs"],
)
def test_k5_route_equals_natural_route_bit_for_bit(monkeypatch, k5_calls, plant, horizon, backend, logs):
    """B = 128 (tile_s 1), float64: one K5 call per trip, and every field (and log) equal to the natural route's."""
    prob = {"quadrotor": quadrotor, "cartpole": cartpole}[plant](128, horizon)
    assert tbatch._linquad_applies(prob[0], prob[1], prob[3], prob[4])
    solve = batched_ilqr_solve_with_logs if logs else batched_ilqr_solve
    got = solve(*prob, CONFIG, riccati_backend=backend)
    trips = int((got[0] if logs else got).iterations.max())
    assert trips >= 2 and k5_calls == [128] * trips
    with natural_route(monkeypatch):
        ref = solve(*prob, CONFIG, riccati_backend=backend)
    assert len(k5_calls) == trips
    if logs:
        assert_bit_equal(got[1], ref[1])
        got, ref = got[0], ref[0]
    assert_bit_equal(got, ref)


def zero_predictor(window, horizon, m, n):
    """A stand-in gain predictor for the hybrid solve: zero gains on the head."""
    return lambda xs, prompt: xs.new_zeros((xs.shape[0], horizon - window, m * (1 + n)))


def user_plant(prob):
    dyn = prob[0]
    return (lambda x, u: dyn(x, u),) + prob[1:]


def user_cost(prob):
    cost = prob[1]
    return (prob[0], lambda x, u: cost(x, u)) + prob[2:]


FALLBACKS = {
    "unaligned-batch": (lambda: quadrotor(100, 8), "fused"),
    "user-plant": (lambda: user_plant(quadrotor(128, 8)), "fused"),
    "user-cost": (lambda: user_cost(quadrotor(128, 8)), "fused_bf16"),
    "vmap-backend": (lambda: quadrotor(128, 8), "vmap"),
    "hybrid": (lambda: quadrotor(128, 8), "fused"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_dispatch_falls_back_to_vmap_without_raising(monkeypatch, k5_calls, case):
    """No K5 call, and the result of the natural route (the parent's path), field for field."""
    make, backend = FALLBACKS[case]
    prob = make()
    if case == "hybrid":  # the hybrid solve's exact fallback keeps the natural layout on every batch
        predict = zero_predictor(4, 8, 4, 12)
        solve = lambda: batched_hybrid_ilqr_solve(*prob[:3], predict, 4, *prob[3:], prob[1].x_ref, CONFIG,
                                                  exact_fallback=True, riccati_backend=backend)
    else:
        assert backend == "vmap" or not tbatch._linquad_applies(prob[0], prob[1], prob[3], prob[4])
        solve = lambda: batched_ilqr_solve(*prob, CONFIG, riccati_backend=backend)
    got = solve()
    with natural_route(monkeypatch):
        ref = solve()
    assert k5_calls == [] and bool(torch.isfinite(got.cost).all())
    assert_bit_equal(got, ref)


def linquad_trip_frac(trips):
    """The benchmark's reader of ``linquad_trip_frac.batch`` over the recorder, in a window that holds every span."""
    notes = []
    ctx = SimpleNamespace(trace=harness.Trace([], 0, (0, 1 << 62)), launches={"fused_riccati_batched": trips},
                          work={"calls": 1}, note=notes.append)
    return harness.Cell("quad-h50-batch65536").reader("linquad_trip_frac.batch").read(ctx), notes


@pytest.mark.parametrize("case", ["k5", "unaligned-batch", "vmap-backend", "no-counter"])
def test_linquad_trips_counts_the_trips_on_the_k5_route(case):
    """With tracing on, ``batch.linquad_trips`` is the trips on the K5 route (every ``batch.trip``), else 0; span
    ``batch.derivatives`` opens once a trip on either route. The benchmark's ``linquad_trip_frac.batch`` reads
    1.0 and 0.0 from them, and nothing where the program keeps no such counter (the parent of the K5 route)."""
    prob = cartpole(100 if case == "unaligned-batch" else 128, 6)
    backend = "vmap" if case == "vmap-backend" else "fused"
    with timing.tracing(True):
        sol = batched_ilqr_solve(*prob, CONFIG, riccati_backend=backend)
    trips = int(sol.iterations.max())
    names = [s[1] for s in timing.spans()]
    assert trips >= 2 and names.count("batch.trip") == names.count("batch.derivatives") == trips
    assert timing.counters()["batch.linquad_trips"] == (0 if case in ("unaligned-batch", "vmap-backend") else trips)
    if case == "no-counter":
        del timing.RECORDER.counts["batch.linquad_trips"]
    frac, notes = linquad_trip_frac(trips)
    assert frac == {"k5": 1.0, "no-counter": None}.get(case, 0.0)
    assert len(notes) == (frac is not None) and all(f"{trips} K4 launches over 1 calls" in note for note in notes)
