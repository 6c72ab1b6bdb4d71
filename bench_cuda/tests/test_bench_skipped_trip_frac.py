"""The reader of ``skipped_trip_frac.mpc`` on the synthetic MPC steps of ``test_bench_program_spans``."""

import pytest

from bench_cuda.tests.test_bench_program_spans import MPC_CELL, context, fill, mpc_steps, read, recorder  # noqa: F401


@pytest.mark.parametrize("counters,expected", [
    ({"mpc.trips": 3, "mpc.trips_skipped": 9}, 0.75),  # two solves of six trips that needed 1 and 2
    ({"mpc.trips": 12, "mpc.trips_skipped": 0}, 0.0),  # every trip needed
    ({"mpc.trips": 12}, None),  # a program without the counter: its K3 runs every trip
    (None, None),
])
def test_skipped_trips_over_the_trip_budget(recorder, counters, expected):  # noqa: F811
    spans, events = mpc_steps()
    fill(recorder, spans, counters)
    ctx, notes, cell = context(MPC_CELL, events)
    assert read(cell, "skipped_trip_frac.mpc", ctx) == expected
    assert any("in 2 steps" in note for note in notes) == (expected is not None)


def test_manifest_entry():
    from bench_cuda import harness
    entry = {m["name"]: m for m in harness.manifest()["per_layer"]}["skipped_trip_frac.mpc"]
    assert entry == {"name": "skipped_trip_frac.mpc", "unit": "frac", "better": "higher", "source": "program_counter",
                     "layer": "ops/fused_solve.py K3", "moves": "mpc_step_ms",
                     "workloads": [MPC_CELL, "cartpole-h30-mpc-megakernel"]}


def test_a_program_without_the_recorder_reads_none(recorder, monkeypatch):  # noqa: F811
    """The parent of the change that added the spans has no ``timing.spans``: the reader finds nothing."""
    from quattro_tpu_torch.utils import timing
    spans, events = mpc_steps()
    fill(recorder, spans, {"mpc.trips": 3, "mpc.trips_skipped": 9})
    monkeypatch.delattr(timing, "spans")
    ctx, _, cell = context(MPC_CELL, events)
    assert read(cell, "skipped_trip_frac.mpc", ctx) is None
