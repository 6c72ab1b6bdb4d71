"""The comparison that decides ``correct`` has teeth: the control and each fault a cell can have come out false.

Each case drives the rest of a run on the CPU (the harness's look for a card
skipped, the program's plain forms in its place) at the sizes of
``conftest.SMALL``, with the timed path broken underneath where a fault is
planted. A sound run of each driver comes out true.
"""

import dataclasses

import pytest
import torch

from bench_cuda.tests.conftest import run_cell

MPC_CELL, BATCH_CELL = "cartpole-h30-mpc-megakernel", "quad-h50-batch65536"


def _broken_controller(monkeypatch, fault):
    import quattro_tpu_torch.control as control

    real = control.make_cartpole_mpc

    def factory(**kwargs):
        ctrl = real(**kwargs)
        inner = ctrl.step

        def step(x, state):
            if fault == "state_unchanged":
                return state.u_warm[0], x.new_zeros((ctrl.horizon + 1, x.shape[0])), state
            u, plan, new_state = inner(x, state)
            return u + 0.01, plan, new_state  # an answer altered where it is produced

        return dataclasses.replace(ctrl, step=step)

    monkeypatch.setattr(control, "make_cartpole_mpc", factory)


def _broken_batch(monkeypatch, fault):
    import quattro_tpu_torch.parallel.batch as batch

    real = batch.batched_ilqr_solve

    def solve(dynamics, cost, final_cost, x0, u0, config, riccati_backend="auto"):
        if fault == "state_unchanged":
            half = 0
        elif fault == "half_batch":
            half = x0.shape[0] // 2
        else:
            sol = real(dynamics, cost, final_cost, x0, u0, config, riccati_backend)
            return sol._replace(u_seq=sol.u_seq + 0.01)  # an answer altered where it is produced
        sol = real(dynamics, cost, final_cost, x0[:half], u0[:half], config, riccati_backend) if half else None
        from quattro_tpu_torch.solver import simulate

        rest = torch.stack([simulate(dynamics, x, u) for x, u in zip(x0[half:], u0[half:])])
        fill = lambda solved, unsolved: unsolved if sol is None else torch.cat([solved, unsolved])
        lanes = x0.shape[0] - half
        return batch.ILQRSolution(
            fill(sol and sol.x_seq, rest), fill(sol and sol.u_seq, u0[half:]),
            fill(sol and sol.cost, x0.new_zeros(lanes)), fill(sol and sol.iterations, torch.zeros(lanes, dtype=torch.int32)),
            fill(sol and sol.converged, torch.ones(lanes, dtype=torch.bool)), None, None)

    monkeypatch.setattr(batch, "batched_ilqr_solve", solve)


@pytest.mark.parametrize("cell", [MPC_CELL, BATCH_CELL])
def test_sound_run_is_correct(small_copy, capsys, cell):
    result = run_cell(small_copy, cell, capsys)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", [MPC_CELL, BATCH_CELL])
def test_control_is_not_correct(small_copy, capsys, cell):
    result = run_cell(small_copy, cell, capsys, variant="control")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_mpc_faults_are_not_correct(small_copy, capsys, monkeypatch, fault):
    _broken_controller(monkeypatch, fault)
    assert run_cell(small_copy, MPC_CELL, capsys)["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_batch_faults_are_not_correct(small_copy, capsys, monkeypatch, fault):
    _broken_batch(monkeypatch, fault)
    assert run_cell(small_copy, BATCH_CELL, capsys)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [MPC_CELL, BATCH_CELL])
def test_a_short_run_on_the_card_is_correct(bench_copy, capsys, cell):
    """On the card: a short run of the cell at its own sizes, through the same entry as the driver's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's kernels run only on the card")
    from bench_cuda import run

    assert run.main(["--workload", cell, "--seed", "7", "--seconds", "2", "--trace", "0"]) == 0
    import json

    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is True
