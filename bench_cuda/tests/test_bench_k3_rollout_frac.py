"""The reader of ``k3_rollout_frac.mpc`` on the synthetic MPC steps of ``test_bench_program_spans``."""

import pytest

from bench_cuda.tests.test_bench_program_spans import MPC_CELL, context, fill, mpc_steps, read, recorder  # noqa: F401


@pytest.mark.parametrize("rollouts,expected", [(2, 1.0), (0, 0.0), (None, None)])
def test_k3_rollouts_over_the_steps(recorder, rollouts, expected):  # noqa: F811
    """Two steps in the window: both rolled out in K3, neither, and a program without the counter (None)."""
    spans, events = mpc_steps()
    fill(recorder, spans, None if rollouts is None else {"mpc.k3_rollouts": rollouts})
    ctx, notes, cell = context(MPC_CELL, events)
    assert read(cell, "k3_rollout_frac.mpc", ctx) == expected
    assert any("over 2 steps" in note for note in notes) == (expected is not None)
