"""The reader of ``k7_roofline``: the trips' rollouts, and one single-step-size rollout of the batch for each
batched rollout launch beyond the K4 launches, on a synthetic context of the batch cell."""

from types import SimpleNamespace

import pytest

from bench_cuda import harness
from bench_cuda.work.kernels import bound_ms, k6_work

BATCH_CELL, CALLS, TRIPS, BATCH = "quad-h50-batch65536", 20, 8, 65536


def _read(launches):
    cell = harness.Cell(BATCH_CELL)
    notes = []
    ctx = SimpleNamespace(trace=SimpleNamespace(kernel_s=lambda pattern: 0.25), launches=launches, config=cell.config,
                          traffic=cell.traffic, work={"lane_iterations": CALLS * TRIPS * BATCH - 12_345},
                          note=notes.append)
    return cell.reader("k7_roofline").read(ctx), ctx, notes


def _share(ctx, work):
    return 100.0 * 1e-3 * bound_ms(work, ctx.config["dtype"])[0] / 0.25


def _trips(ctx):
    cfg = ctx.config
    return k6_work(ctx.work["lane_iterations"], cfg["horizon"], cfg["state_dim"], cfg["control_dim"],
                   len(cfg["alphas"]), cfg["field_flops"], cfg["dtype"])


def test_one_launch_a_trip_counts_the_trips_alone():
    value, ctx, notes = _read({"fused_riccati_batched": CALLS * TRIPS, "fused_rollout_batched": CALLS * TRIPS})
    assert value == _share(ctx, _trips(ctx))  # the parent's reading, to the last digit
    assert any("0 beyond the trips'" in note for note in notes)


@pytest.mark.parametrize("name", ["fused_rollout_batched", "fused_rollout_batched2d"])
def test_a_warm_start_launch_a_call_adds_a_single_step_size_rollout_of_the_batch(name):
    launches = {"fused_riccati_batched": CALLS * TRIPS, "fused_rollout_batched": CALLS * TRIPS}
    launches[name] = launches.get(name, 0) + CALLS
    value, ctx, notes = _read(launches)
    cfg = ctx.config
    single = k6_work(BATCH, cfg["horizon"], cfg["state_dim"], cfg["control_dim"], 1, cfg["field_flops"], cfg["dtype"])
    trips = _trips(ctx)
    assert value == pytest.approx(_share(ctx, (trips[0] + CALLS * single[0], trips[1] + CALLS * single[1])), rel=1e-12)
    assert value > _read({"fused_riccati_batched": CALLS * TRIPS, "fused_rollout_batched": CALLS * TRIPS})[0]
    assert any(f"{CALLS} beyond the trips'" in note for note in notes)


def test_no_rollout_on_the_device_reads_none():
    cell = harness.Cell(BATCH_CELL)
    ctx = SimpleNamespace(trace=SimpleNamespace(kernel_s=lambda pattern: 0.0), launches={}, config=cell.config,
                          traffic=cell.traffic, work={"lane_iterations": 1}, note=lambda note: None)
    assert cell.reader("k7_roofline").read(ctx) is None
