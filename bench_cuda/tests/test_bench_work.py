"""The frozen work model at small shapes, counted by hand."""

import pytest

from bench_cuda.work import kernels


def test_k1_work_one_step_scalar():
    # n = m = 1: inputs 1 * (2 + 1 + 1 + 1 + 1 + 1) + 1 + 1 = 9, outputs 2 + 2 * 2 = 6 entries.
    # Step: 4 + 8 + 2 + 2 + 2 (Q) + 0 + 4 (Cholesky) + 2 + 4 + 4 (value) = 32.
    assert kernels.k1_work(1, 1, 1, "float32") == (15 * 4, 32)
    assert kernels.k1_work(3, 1, 1, "float64") == ((3 * 7 + 2 + 3 * 2 + 4 * 2) * 8, 96)


def test_k2_and_k6_work():
    # H = 1, n = m = 1, one step size, a field of 1 flop: inputs 1 + (1 + 1 + 1 + 1) + 1 = 6,
    # outputs 1 * (2 + 1) = 3; a step 4 + 1 + 4 + 6 + 5 = 20.
    assert kernels.k2_work(1, 1, 1, 1, 1, "float32") == (9 * 4, 20)
    # The batch of 2: inputs 2 * (1 + 2 + (2 + 1)) + 1 = 13, outputs 1 * 2 * 3 = 6.
    assert kernels.k6_work(2, 1, 1, 1, 1, 1, "float32") == (19 * 4, 40)


def test_k3_work_counts_the_trips_it_is_given():
    one = kernels.k3_work(2, 1, 1, 1, 1, 1, "float32")
    three = kernels.k3_work(2, 1, 1, 1, 3, 1, "float32")
    assert one[0] == three[0] and three[1] == 3 * one[1]
    assert one[1] == kernels.trip_flops(2, 1, 1, 1, 1, "float32")
    # linearize 2 * ((4 + 6) + 2 * (8 + 12)) = 100, quadratize 2 * 34 = 68, Riccati 64, rollouts 2 * (4 + 1 + 4 + 11 + 20) = 80.
    assert one[1] == 100 + 68 + 64 + 80


def test_k4_work_and_bound():
    nbytes, flops = kernels.k4_work(2, 1, 1, 1, "float32")
    # stage entries 2 + 2 + 1 + 1 + 1 = 7, plus V_x and V_xx: 9 a lane in, 2 out.
    assert (nbytes, flops) == (2 * 11 * 4, 2 * 32)
    assert kernels.bound_ms((3.35e12, 0), "float32") == (1e3, "bytes")
    assert kernels.bound_ms((0, 67e12), "float32") == (pytest.approx(1e3), "operations")
    assert kernels.bound_ms((0, 34e12), "float64")[0] == pytest.approx(1e3)


def test_iterations_per_step_weights_first_steps_by_their_share_of_the_window():
    from bench_cuda.drivers.mpc import iterations_per_step

    # 8 judged first steps at 6 iterations and 24 others at 1.5, from a window of 12 episodes and 3,000 steps.
    assert iterations_per_step([6] * 8, [1.5] * 24, 12, 3000) == pytest.approx((12 * 6 + 2988 * 1.5) / 3000)
    assert iterations_per_step([6, 4], [], 2, 2) == 5.0


def test_one_mfu_reader_serves_every_cell():
    from types import SimpleNamespace

    from bench_cuda import harness

    for cell, metric in (("quad-h50-batch65536", "mfu.batch"), ("quad-h50-mpc-megakernel", "mfu.mpc")):
        found = harness.Cell(cell)
        ctx = SimpleNamespace(work={"window_flops": 67e12}, trace=SimpleNamespace(window_s=10.0), config=found.config)
        assert found.reader(metric).read(ctx) == pytest.approx(10.0)
        assert found.reader(metric).__file__.endswith("metrics/mfu.py")
