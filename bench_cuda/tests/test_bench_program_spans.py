"""The readers of the program's spans and counters, on a synthetic trace with spans of a known layout.

Host times are in ns on the recorder's clock; the trace runs 1,000 ns ahead
(the offset), so a span at host t sits at trace t + 1,000. The window is host
0 to 100,000 (300,000 where a test runs six steps).
"""

import re
from types import SimpleNamespace

import pytest

from bench_cuda import harness, program_spans
from quattro_tpu_torch.utils import timing

MPC_CELL, BATCH_CELL = "quad-h50-mpc-megakernel", "quad-h50-batch65536"
OFFSET, WINDOW, LONG = 1_000, (0, 100_000), (0, 300_000)


class FakeEvents:
    """A pair of CUDA events as the recorder keeps them, ``ms`` apart."""

    def __init__(self, ms):
        self.ms = ms

    def __getitem__(self, i):
        return self

    def query(self):
        return True

    def elapsed_time(self, other):
        return self.ms


@pytest.fixture(autouse=True)
def recorder():
    timing.reset(timing.SPAN_CAPACITY)
    yield timing.RECORDER
    timing.reset(timing.SPAN_CAPACITY)


def fill(rec, spans, counters=None):
    """``spans``: (name, start, end, parent index, device ms or None), indexed in order."""
    for index, (name, s, e, parent, ms) in enumerate(spans):
        rec.ring.append((index, name, s, e, parent, None if ms is None else FakeEvents(ms)))
    rec.counts.update(counters or {})


def mpc_steps(first_start=10_000, kernel_start=17_000, kernel_end=27_000, steps=2, jump=0):
    """MPC steps 40,000 ns apart. The first K3 launch runs from ``kernel_start`` to ``kernel_end`` on the trace
    (its launch span starts at trace 16,000 and its read ends at 29,000), each later one 40,000 ns later, and
    ``jump`` ns earlier from the second on (the trace's clock stepping back against the host's)."""
    spans, events = [], []
    for k in range(steps):
        base = first_start + 40_000 * k
        i = len(spans)
        spans += [("mpc.step", base, base + 20_000, -1, None),
                  ("mpc.initial_rollout", base + 1_000, base + 4_000, i, None),
                  ("mpc.k3_launch", base + 5_000, base + 8_000, i, None),
                  ("mpc.stats_read", base + 9_000, base + 18_000, i, None)]
        shift = base - 10_000 - (jump if k else 0)
        events += [("rollout_group_kernel", 13_000 + shift, 1_000),
                   ("solve_kernel", kernel_start + shift, kernel_end - kernel_start)]
    return spans, events


def context(cell, events, traffic=None, work=None, window=WINDOW):
    notes = []
    found = harness.Cell(cell)
    ctx = SimpleNamespace(trace=harness.Trace(events, OFFSET, window), launches={}, config=found.config,
                          traffic={**found.traffic, **(traffic or {})}, work=work or {}, note=notes.append)
    return ctx, notes, found


def read(found, metric, ctx):
    return found.reader(metric).read(ctx)


def test_idle_split_by_innermost_program_span(recorder):
    spans, events = mpc_steps()
    fill(recorder, spans)
    ctx, notes, cell = context(MPC_CELL, events)
    # K3's read returns right after K3 (the tight side): each launch ties the clocks 2,000 ns earlier than the
    # harness's offset, so a span at host t sits at trace t - 1,000. Trace gaps: 14,000-17,000 (middle in the
    # first step's K3 launch), 27,000-53,000 (middle 40,000: outside any step), 54,000-57,000 (the second step's
    # K3 launch), 67,000 to the window's end at 101,000 (outside).
    assert read(cell, "idle_in_program_ms.mpc", ctx) == pytest.approx(1e-6 * (3_000 + 3_000) / 2)
    assert any("{'mpc.k3_launch': 0.003" in note and "2 launches paired (0 kernel events and 0 holders" in note
               and "moved the harness's offset by -2000 to -2000 ns" in note and "allowing 3000 ns" in note
               and "the worst margin between a launch's end and its read's is 2000 ns" in note for note in notes)
    tie, fault = program_spans.clock_tie(ctx, program_spans.load(ctx), program_spans.UNITS["mpc"])
    program = program_spans.load(ctx, tie.shift)  # innermost takes trace times
    assert program.innermost(15_500)[1] == "mpc.k3_launch"
    assert program.innermost(12_000)[1] == "mpc.initial_rollout"
    assert program.innermost(28_000)[1] == "mpc.step"
    assert program.innermost(40_000) is None and program.innermost(500) is None


def test_spans_are_clipped_to_the_window(recorder):
    spans, events = mpc_steps(first_start=-15_000)  # the first step starts before the window
    fill(recorder, spans + [("mpc.step", 120_000, 130_000, -1, None)])  # one after it
    ctx, _, cell = context(MPC_CELL, [e for e in events if e[1] > 0])
    program = program_spans.load(ctx)
    first = program.named("mpc.step")[0]
    assert (first[2], first[3]) == (WINDOW[0] + OFFSET, 5_000 + OFFSET)
    assert len(program.named("mpc.step")) == 2
    assert [s[1] for s in program.named("mpc.initial_rollout")] == ["mpc.initial_rollout"]  # the first is outside
    # stats_wait: the first read (host -6,000 .. 3,000) clipped to the window's 0 .. 3,000, the second whole.
    assert read(cell, "stats_wait_ms.mpc", ctx) == pytest.approx(1e-6 * (3_000 + 9_000) / 2)


def test_mpc_host_time_wait_and_useful_trips(recorder):
    spans, events = mpc_steps()
    fill(recorder, spans, {"mpc.iterations": 5, "mpc.trips": 12})
    ctx, notes, cell = context(MPC_CELL, events, work={"iterations_per_step": 2.2})
    assert read(cell, "step_host_ms.mpc", ctx) == pytest.approx(1e-6 * (20_000 - 9_000))
    assert read(cell, "stats_wait_ms.mpc", ctx) == pytest.approx(9e-3)
    assert read(cell, "useful_trip_frac.mpc", ctx) == pytest.approx(5 / 12)
    assert any("2.5 iterations per step counted" in note and "estimates 2.2" in note for note in notes)


def test_clock_tie_follows_a_jumping_trace_clock(recorder):
    # From the second launch on the trace's clock runs 5,000 ns behind: no single offset fits both launches,
    # but each launch ties the clocks on its own.
    spans, events = mpc_steps(jump=5_000)
    fill(recorder, spans)
    ctx, notes, cell = context(MPC_CELL, events)
    tie, fault = program_spans.clock_tie(ctx, program_spans.load(ctx), program_spans.UNITS["mpc"])
    assert fault == "" and [pair[1:] for pair in tie.pairs] == [(-2_000, -2_000, 1_000), (-7_000, -7_000, -4_000)]
    assert read(cell, "idle_in_program_ms.mpc", ctx) == pytest.approx(1e-6 * (3_000 + 3_000) / 2)
    assert any("moved the harness's offset by -7000 to -2000 ns" in note for note in notes)


def test_clock_tie_refuses_a_launch_that_outlasts_its_spans(recorder):
    # K3 starting 500 ns before its launch span began and ending 500 ns after its read returned: no shift fits.
    spans, events = mpc_steps(steps=4)
    fill(recorder, spans)
    bad = [(name, s - 1_500, d + 4_000) if name == "solve_kernel" and s > 60_000 else (name, s, d)
           for name, s, d in events]
    ctx, notes, cell = context(MPC_CELL, bad, window=LONG)
    tie, fault = program_spans.clock_tie(ctx, program_spans.load(ctx), program_spans.UNITS["mpc"])
    assert tie is None and "launch 2 ends 1000 ns too late for its spans" in fault
    assert read(cell, "idle_in_program_ms.mpc", ctx) is None
    assert any("clock check failed" in note for note in notes)


def test_clock_tie_leaves_edges_unpaired_and_refuses_many(recorder):
    spans, events = mpc_steps(steps=6)
    fill(recorder, spans)
    # The window's end cut the last launch off: paired all the same.
    ctx, notes, cell = context(MPC_CELL, events[:-1], window=LONG)
    assert read(cell, "idle_in_program_ms.mpc", ctx) is not None
    assert any("5 launches paired (0 kernel events and 1 holders left over" in note for note in notes)
    # Only one launch of six in the trace: the spans and the trace do not belong together.
    ctx, notes, cell = context(MPC_CELL, events[:2], window=LONG)
    assert read(cell, "idle_in_program_ms.mpc", ctx) is None
    assert any("5 holders left unpaired" in note for note in notes)


def batch_call():
    """One call of three trips; the last reaches max_iter and makes no read."""
    spans = [("batch.solve", 1_000, 90_000, -1, None), ("batch.initial", 2_000, 5_000, 0, None)]
    events = []
    for k, base in enumerate((10_000, 35_000, 60_000)):
        trip = len(spans)
        spans += [("batch.trip", base, base + 20_000, 0, None),
                  ("batch.derivatives", base + 1_000, base + 6_000, trip, 4.0 + k)]
        if k < 2:
            spans.append(("batch.done_read", base + 12_000, base + 20_000, trip, None))
        events.append(("void riccati_batched_kernel<float>", base + 8_000 + OFFSET, 3_000))
    return spans, events


def test_batch_readers(recorder):
    spans, events = batch_call()
    fill(recorder, spans, {"batch.lanes_active": 16 + 16 + 8})
    ctx, notes, cell = context(BATCH_CELL, events, traffic={"batch": 16}, work={"lane_iterations": 40})
    assert read(cell, "trip_host_ms.batch", ctx) == pytest.approx(1e-6 * (12_000 + 12_000 + 20_000) / 3)
    assert read(cell, "derivatives_ms.batch", ctx) == pytest.approx(5.0)
    assert read(cell, "active_lane_frac.batch", ctx) == pytest.approx(40 / 48)
    assert any("40 active lanes" in note and "returned 40 lane-iterations" in note for note in notes)
    # Idle under the call: every gap between the K4 events with its middle in batch.solve.
    idle = read(cell, "idle_in_program_ms.batch", ctx)
    gaps = program_spans.idle_gaps(ctx.trace)
    inside = [e - s for s, e in gaps if 1_000 + OFFSET <= (s + e) // 2 < 90_000 + OFFSET]
    assert idle == pytest.approx(1e-6 * sum(inside)) and idle > 0
    # K7 and the selects run between K4 and the trip's read, so the tie keeps the harness's offset where it fits.
    assert any("3 launches paired" in note and "moved the harness's offset by 0 to 0 ns" in note
               and "allowing 17000 ns" in note and "worst margin between a launch's end and its read's is 9000 ns"
               in note for note in notes)


@pytest.mark.parametrize("cell,metric", [(MPC_CELL, m) for m in ("step_host_ms.mpc", "stats_wait_ms.mpc",
                                                                   "useful_trip_frac.mpc", "idle_in_program_ms.mpc")]
                         + [(BATCH_CELL, m) for m in ("trip_host_ms.batch", "derivatives_ms.batch",
                                                      "active_lane_frac.batch", "idle_in_program_ms.batch")])
def test_no_spans_read_none(recorder, monkeypatch, cell, metric):
    ctx, _, found = context(cell, [("solve_kernel", 20_000, 1_000), ("riccati_batched_kernel", 30_000, 1_000)])
    assert read(found, metric, ctx) is None
    # A program without the recorder (the parent of the change that added it) reads None too.
    monkeypatch.delattr(timing, "spans")
    fill(recorder, mpc_steps()[0] + batch_call()[0])
    assert read(found, metric, ctx) is None


def test_every_new_metric_has_its_reader():
    new = ["step_host_ms.mpc", "stats_wait_ms.mpc", "useful_trip_frac.mpc", "idle_in_program_ms.mpc",
           "idle_in_program_ms.batch", "trip_host_ms.batch", "derivatives_ms.batch", "active_lane_frac.batch",
           "linquad_trip_frac.batch", "k3_rollout_frac.mpc"]
    entries = {m["name"]: m for m in harness.manifest()["per_layer"]}
    assert set(new) <= set(entries)
    for name in new:
        cells = entries[name]["workloads"]
        assert cells == ([MPC_CELL, "cartpole-h30-mpc-megakernel"] if name.endswith(".mpc") else [BATCH_CELL])
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", entries[name]["unit"])
        assert callable(harness.Cell(cells[0]).reader(name).read)
