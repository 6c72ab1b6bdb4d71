"""The program's spans and counters (``quattro_tpu_torch.utils.timing``) on the CPU.

The recorder records nothing with tracing off, nests spans by parent with it
on, keeps a bounded ring and follows the profiler by default. The MPC step
and the batched solve record the spans and counters the benchmark's readers
take (one ``mpc.stats_read`` per step, one ``batch.trip`` per trip, the
active lanes of every trip), and tracing changes neither their results nor
their host reads.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.control import make_quadrotor_mpc
from quattro_tpu_torch.control import mpc as mpc_module
from quattro_tpu_torch.parallel import batched_ilqr_solve
from quattro_tpu_torch.utils import PhaseTimer, timing


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.reset(timing.SPAN_CAPACITY)
    yield
    timing.tracing(None)
    timing.reset(timing.SPAN_CAPACITY)


class HostReads(TorchDispatchMode):
    """Counts the reads of a tensor's value by the host (``item``, ``int``, ``bool``, ``tolist``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def by_name(name):
    return [s for s in timing.spans() if s[1] == name]


def cartpole_batch(batch=6, horizon=12, seed=0):
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    dyn = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4")
    cost = tsolver.make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), torch.zeros(4, dtype=torch.float64))
    fcost = tsolver.make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), torch.zeros(4, dtype=torch.float64))
    x0 = torch.from_numpy(0.3 * np.random.default_rng(seed).standard_normal((batch, 4)))
    return dyn, cost, fcost, x0, torch.zeros((batch, horizon, 1), dtype=torch.float64)


def test_off_records_nothing():
    timing.tracing(False)
    with timing.span("a"):
        with timing.span("b", device=True):
            timing.count("c", 3)
    assert timing.spans() == [] and timing.counters() == {}
    timing.tracing(None)  # the default: no profiler session, so off
    with timing.span("a"):
        timing.count("c", 3)
    assert timing.spans() == [] and timing.counters() == {}


def test_on_nests_parents_and_counts():
    with timing.tracing(True):
        with timing.span("outer"):
            with timing.span("first"):
                timing.count("n", 2)
            with timing.span("second"):
                with timing.span("inner"):
                    timing.count("n", 5)
        with timing.span("next"):
            pass
    with timing.span("after"):  # the ``with`` restored the default
        pass
    records = timing.spans()
    assert [(r[0], r[1], r[4]) for r in records] == [
        (0, "outer", -1), (1, "first", 0), (2, "second", 0), (3, "inner", 2), (4, "next", -1)]
    assert all(r[2] <= r[3] for r in records)
    outer, first, second, inner, _ = records
    assert outer[2] <= first[2] and first[3] <= second[2] and second[2] <= inner[2] and inner[3] <= outer[3]
    assert timing.counters() == {"n": 7}
    summary = timing.RECORDER.summary()
    assert summary["outer"]["count"] == 1 and summary["outer"]["total_s"] > 0
    timer = PhaseTimer()
    timer.timed("p", lambda: None)
    assert set(summary["outer"]) == set(timer.summary()["p"])
    timing.reset()
    assert timing.spans() == [] and timing.counters() == {}


def test_ring_is_bounded():
    timing.reset(4)
    with timing.tracing(True):
        for i in range(10):
            with timing.span(f"s{i}"):
                pass
    assert [r[1] for r in timing.spans()] == ["s6", "s7", "s8", "s9"]
    assert timing.RECORDER.ring.maxlen == 4


@pytest.mark.parametrize("device", [True, torch.device("cpu")], ids=["true", "cpu-device"])
def test_device_span_on_cpu_records_no_event(device):
    with timing.tracing(True):
        with timing.span("d", device=device):
            torch.ones(3).sum()
    (record,) = timing.spans()
    assert record[1] == "d" and record[5] is None
    assert timing.RECORDER.ring[0][5] is None  # no CUDA event was made


def test_profiler_session_turns_tracing_on():
    from torch.profiler import ProfilerActivity, profile

    with timing.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("inside"):
            timing.count("c", 1)
    with timing.span("after"):
        pass
    assert [r[1] for r in timing.spans()] == ["inside"] and timing.counters() == {"c": 1}


@pytest.mark.parametrize("max_iter", [20, 3], ids=["converges", "max-iter"])
def test_batched_solve_trips_and_active_lanes(max_iter):
    prob = cartpole_batch()
    config = tsolver.ILQRConfig(tol=1e-1, max_iter=max_iter, linesearch="fused")
    with timing.tracing(True):
        sol = batched_ilqr_solve(*prob, config, riccati_backend="fused")
    trips = int(sol.iterations.max())
    assert timing.counters()["batch.lanes_active"] == int(sol.iterations.sum())
    (solve,) = by_name("batch.solve")
    trip_spans, reads = by_name("batch.trip"), by_name("batch.done_read")
    assert len(trip_spans) == trips and len(by_name("batch.derivatives")) == trips
    # The trip that reaches max_iter ends without a read: nothing is left to decide.
    assert len(reads) == (trips if trips < max_iter else trips - 1)
    assert bool(sol.converged.all()) == (trips < max_iter)
    trip_ids = {s[0] for s in trip_spans}
    assert all(s[4] == solve[0] for s in trip_spans + by_name("batch.initial"))
    assert all(s[4] in trip_ids for s in reads + by_name("batch.derivatives"))
    assert all(s[5] is None for s in by_name("batch.derivatives"))


def test_traced_and_untraced_batched_solves_are_bit_identical():
    prob = cartpole_batch(batch=5, seed=3)
    config = tsolver.ILQRConfig(tol=1e-2, max_iter=6, linesearch="fused")
    out = {}
    for on in (False, True):
        timing.tracing(on)
        with HostReads() as mode:
            out[on] = (batched_ilqr_solve(*prob, config, riccati_backend="fused"), mode.reads)
    assert out[True][1] == out[False][1] > 0  # tracing adds no host read
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_megakernel_mpc_step_spans_and_iterations(monkeypatch):
    solved = []
    fused = mpc_module.ilqr_solve_fused

    def spy(*args, **kwargs):
        solved.append(fused(*args, **kwargs))
        return solved[-1]

    monkeypatch.setattr(mpc_module, "ilqr_solve_fused", spy)
    ctrl = make_quadrotor_mpc(horizon=8, solver="megakernel", max_iter=3, device="cpu", dtype=torch.float64)
    x = torch.zeros(12, dtype=torch.float64)
    x[2], x[6] = 0.2, 0.15
    state = ctrl.init_state(dtype=torch.float64)
    steps, out, counted = 3, {}, [0]
    for on in (False, True):
        timing.reset()
        timing.tracing(on)
        xs, st, results = x, state, []
        with HostReads() as mode:
            for _ in range(steps):
                u, plan, st = ctrl.step(xs, st)
                results.append((u, plan, st.u_warm))
                xs = plan[1]
                counted.append(timing.counters().get("mpc.iterations", 0))
        out[on] = results, mode.reads
    assert out[True][1] == out[False][1] > 0  # tracing adds no host read
    for a, b in zip(out[False][0], out[True][0]):
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    steps_, reads = by_name("mpc.step"), by_name("mpc.stats_read")
    assert len(steps_) == len(reads) == len(by_name("mpc.k3_launch")) == len(by_name("mpc.initial_rollout")) == steps
    step_ids = [s[0] for s in steps_]
    assert [s[4] for s in reads] == step_ids and all(s[4] == -1 for s in steps_)
    iterations = [sol.iterations for sol in solved[steps:]]
    assert np.diff(counted[steps:]).tolist() == iterations and counted[1:steps + 1] == [0] * steps
    # CPU tensors take the host's initial rollout: no solve counts a rollout inside K3. K3 leaves its loop at
    # `done`, so the trips run are the iterations, and the rest of each solve's budget of 3 is skipped.
    assert timing.counters() == {"mpc.iterations": sum(iterations), "mpc.trips": sum(iterations),
                                 "mpc.trips_skipped": 3 * steps - sum(iterations), "mpc.k3_rollouts": 0}
    assert all(1 <= i <= 3 for i in iterations)


@pytest.mark.cuda
def test_megakernel_mpc_step_on_card_rolls_out_in_k3():
    """On the card K3 rolls out and costs the warm start: one count a step, no ``mpc.initial_rollout`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only on the GPU")
    ctrl = make_quadrotor_mpc(horizon=8, solver="megakernel", max_iter=3)
    x = torch.zeros(12, device="cuda")
    x[2], x[6] = 0.2, 0.15
    state, steps = ctrl.init_state(), 3
    timing.tracing(True)
    for _ in range(steps):
        _, plan, state = ctrl.step(x, state)
        x = plan[1]
    counters = timing.counters()
    assert counters["mpc.k3_rollouts"] == steps
    assert counters["mpc.trips"] == counters["mpc.iterations"] >= steps
    assert counters["mpc.trips_skipped"] == 3 * steps - counters["mpc.iterations"]
    assert len(by_name("mpc.step")) == len(by_name("mpc.k3_launch")) == len(by_name("mpc.stats_read")) == steps
    assert by_name("mpc.initial_rollout") == []
