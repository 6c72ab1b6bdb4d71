"""The port's CUDA kernels on the card, against their plain PyTorch forms.

Every test here is marked ``cuda`` and skips without a card. The file imports
neither JAX nor ``quattro_tpu``, so it also runs on a machine that has only
PyTorch; ``tests/conftest.py`` configures JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are made from numpy seeds; float64, rtol 1e-9 (the kernel and the
plain form sum in different orders).
"""

import numpy as np
import pytest
import torch

from quattro_tpu_torch.control import make_quadrotor_mpc
from quattro_tpu_torch.ops import _build, fused_riccati, fused_rollout, fused_solve
from quattro_tpu_torch.solver import (
    CostExpansion, ILQRConfig, ilqr_solve, ilqr_solve_fused, make_quadratic_cost, make_quadratic_final_cost,
    simulate, trajectory_cost,
)
from quattro_tpu_torch.systems import CartPoleField, QuadrotorField, make_discrete, quadrotor_dynamics

RTOL = 1e-9
ATOL = 1e-11
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only on the GPU")
    return torch.device("cuda")


def _close_all(ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.cpu().numpy(), r.cpu().numpy(), rtol=RTOL, atol=ATOL)


def riccati_stages(device, seed=8, horizon=8, n=12, m=4):
    rng = np.random.default_rng(seed)

    def spd(d):
        g = rng.standard_normal((horizon, d, d))
        return g @ np.swapaxes(g, -1, -2) / d + np.eye(d)

    t = lambda v: torch.from_numpy(v).to(device)
    a = np.eye(n) + 0.1 * rng.standard_normal((horizon, n, n))
    b = 0.1 * rng.standard_normal((horizon, n, m))
    exp = (rng.standard_normal((horizon, n)), rng.standard_normal((horizon, m)), spd(n), spd(m),
           0.1 * rng.standard_normal((horizon, m, n)))
    g = rng.standard_normal((n, n))
    return t(a), t(b), CostExpansion(*(t(e) for e in exp)), t(rng.standard_normal(n)), t(g @ g.T / n + np.eye(n))


def rollout_inputs(device, seed=3, horizon=100, n=12, m=4, u_mean=2.4525):
    rng = np.random.default_rng(seed)
    values = (
        0.1 * rng.standard_normal(n),
        0.1 * rng.standard_normal((horizon + 1, n)),
        u_mean + 0.1 * rng.standard_normal((horizon, m)),
        0.05 * rng.standard_normal((horizon, m)),
        0.05 * rng.standard_normal((horizon, m, n)),
        np.array([1.0, 0.5, 0.25, 0.1, 0.05, 0.01]),
    )
    return [torch.from_numpy(v).to(device) for v in values]


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [8, 100])
def test_k1_on_card_matches_plain(cuda_device, horizon):
    data = riccati_stages(cuda_device, horizon=horizon)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_fused_single(*data, 1e-6)
    torch.cuda.synchronize()
    assert _build.launches[fused_riccati.KERNEL] == 1
    _close_all(fused_riccati.riccati_backward_fused_single_plain(*data, 1e-6), out)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_k2_on_card_matches_plain(cuda_device, method):
    inputs = rollout_inputs(cuda_device)
    dyn = make_discrete(QuadrotorField(), 0.01, method)
    _build.reset_launches()
    out = fused_rollout.fused_feedback_rollouts(dyn, *inputs)
    torch.cuda.synchronize()
    assert _build.launches[fused_rollout.KERNEL] == 1
    _close_all(fused_rollout.fused_feedback_rollouts_plain(dyn, *inputs), out)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_k2_cartpole_on_card_matches_plain(cuda_device, method):
    inputs = rollout_inputs(cuda_device, seed=5, horizon=30, n=4, m=1, u_mean=0.0)
    dyn = make_discrete(CartPoleField(), 0.01, method)
    _build.reset_launches()
    out = fused_rollout.fused_feedback_rollouts(dyn, *inputs)
    torch.cuda.synchronize()
    assert _build.launches[fused_rollout.KERNEL] == 1
    _close_all(fused_rollout.fused_feedback_rollouts_plain(dyn, *inputs), out)


@pytest.mark.cuda
def test_k2_on_card_refuses_an_unknown_plant(cuda_device):
    dyn = make_discrete(lambda x, u: quadrotor_dynamics(x, u), 0.01, "rk4")
    with pytest.raises(ValueError, match="quadrotor"):
        fused_rollout.fused_feedback_rollouts(dyn, *rollout_inputs(cuda_device))


@pytest.mark.cuda
def test_fused_solve_on_card_matches_seq_xla(cuda_device):
    """The bench problem at H=16: K1 + K2 against the sequential pass and the PyTorch line search."""
    t = lambda v: torch.tensor(v, dtype=torch.float64, device=cuda_device)
    x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
    dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
    cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0)
    fcost = make_quadratic_final_cost(10.0 * t(Q), x_ref)
    x0 = t([0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.1] + [0.0] * 5)
    u0 = torch.zeros(16, 4, dtype=torch.float64, device=cuda_device)
    _build.reset_launches()
    fused = ilqr_solve(dyn, cost, fcost, x0, u0, ILQRConfig(tol=0.0, max_iter=3, riccati="fused", linesearch="fused"))
    assert _build.launches[fused_riccati.KERNEL] == 3 and _build.launches[fused_rollout.KERNEL] == 3
    seq = ilqr_solve(dyn, cost, fcost, x0, u0, ILQRConfig(tol=0.0, max_iter=3, riccati="seq", linesearch="xla"))
    assert fused.iterations == seq.iterations == 3
    _close_all((seq.x_seq, seq.u_seq, seq.cost), (fused.x_seq, fused.u_seq, fused.cost))


def solve_problem(device, plant, horizon):
    """The JAX package's fused-solve test problems: (dyn, cost, fcost, x0, u0), float64."""
    t = lambda v: torch.tensor(v, dtype=torch.float64, device=device)
    if plant == "quadrotor":
        x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
        dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
        cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0)
        fcost = make_quadratic_final_cost(10.0 * t(Q), x_ref)
        x0 = t([0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.1] + [0.0] * 5)
        return dyn, cost, fcost, x0, torch.zeros(horizon, 4, dtype=torch.float64, device=device)
    x_ref = t([0.0] * 4)
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    cost = make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), x_ref)
    fcost = make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), x_ref)
    return dyn, cost, fcost, t([0.15, 0.0, 0.2, 0.0]), torch.zeros(horizon, 1, dtype=torch.float64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "plant,horizon,tol,max_iter",
    [("quadrotor", 20, 0.0, 4), ("quadrotor", 20, 1e-3, 12), ("cartpole", 16, 0.0, 2), ("cartpole", 30, 1e-1, 12),
     ("cartpole", 16, 1e-1, 0)],
)
def test_k3_on_card_matches_plain(cuda_device, plant, horizon, tol, max_iter):
    """x, u and K to rtol 1e-9; the feedforward k, which vanishes at the optimum, on u's scale."""
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, plant, horizon)
    x_init = simulate(dyn, x0, u0)
    cost_init = trajectory_cost(cost, fcost, x_init, u0)
    args = (dyn, cost, fcost, x_init, u0, cost_init, max_iter, tol, 1e-6, (1.0, 0.5, 0.25, 0.1, 0.05, 0.01))
    _build.reset_launches()
    x, u, k, big_k, stats = fused_solve.fused_ilqr_solve_kernel(*args)
    torch.cuda.synchronize()
    assert _build.launches[fused_solve.KERNEL] == 1
    rx, ru, rk, rbig_k, rstats = fused_solve.fused_ilqr_solve_kernel_plain(*args)
    assert stats[0, 1:].tolist() == rstats[0, 1:].tolist()
    _close_all((rx, ru, rbig_k, rstats[0, 0]), (x, u, big_k, stats[0, 0]))
    scale = max(float(ru.abs().max()), float(rk.abs().max()), 1.0)
    assert float((k - rk).abs().max()) <= RTOL * scale


@pytest.mark.cuda
def test_k3_on_card_refuses_unknown_plants_and_costs(cuda_device):
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, "quadrotor", 8)
    x_init = simulate(dyn, x0, u0)
    cost_init = trajectory_cost(cost, fcost, x_init, u0)
    tail = (x_init, u0, cost_init, 2, 1e-3, 1e-6, (1.0, 0.5))
    lam = make_discrete(lambda x, u: quadrotor_dynamics(x, u), 0.01, "rk4")
    _build.reset_launches()
    with pytest.raises(ValueError, match="quadrotor"):
        fused_solve.fused_ilqr_solve_kernel(lam, cost, fcost, *tail)
    with pytest.raises(ValueError, match="make_quadratic_cost"):
        fused_solve.fused_ilqr_solve_kernel(dyn, lambda x, u: cost(x, u), fcost, *tail)
    with pytest.raises(ValueError, match="make_quadratic_final_cost"):
        fused_solve.fused_ilqr_solve_kernel(dyn, cost, lambda x: fcost(x), *tail)
    # The entry point refuses the plant before it rolls anything out.
    with pytest.raises(ValueError, match="quadrotor"):
        ilqr_solve_fused(lam, cost, fcost, x0, u0, ILQRConfig(max_iter=2))
    assert sum(_build.launches.values()) == 0


@pytest.mark.cuda
def test_ilqr_solve_fused_on_card_matches_while_solve(cuda_device):
    """One K3 launch (and one K2 launch for the initial rollout) per solve; same solve as seq + xla."""
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, "quadrotor", 16)
    _build.reset_launches()
    fused = ilqr_solve_fused(dyn, cost, fcost, x0, u0, ILQRConfig(tol=1e-3, max_iter=12))
    assert dict(_build.launches) == {fused_solve.KERNEL: 1, fused_rollout.KERNEL: 1}
    seq = ilqr_solve(dyn, cost, fcost, x0, u0, ILQRConfig(tol=1e-3, max_iter=12, riccati="seq", linesearch="xla"))
    assert fused.iterations == seq.iterations and fused.converged == seq.converged
    # The fused step law and the sequential one place reg differently: 1e-7, as the JAX tests hold them.
    for r, o in zip((seq.x_seq, seq.u_seq, seq.cost), (fused.x_seq, fused.u_seq, fused.cost)):
        np.testing.assert_allclose(o.cpu().numpy(), r.cpu().numpy(), rtol=1e-7, atol=1e-8)


@pytest.mark.cuda
def test_megakernel_mpc_launches_k3_once_per_step(cuda_device):
    ctrl = make_quadrotor_mpc(horizon=20, solver="megakernel", max_iter=4)
    plant = make_discrete(QuadrotorField(), 0.01, "rk4")
    x = torch.zeros(12, device=cuda_device)
    x[2], x[6] = 0.2, 0.15
    state = ctrl.init_state()
    _build.reset_launches()
    for _ in range(3):
        u, x_plan, state = ctrl.step(x, state)
        x = plant(x, u)
    torch.cuda.synchronize()
    assert _build.launches[fused_solve.KERNEL] == 3
    assert _build.launches[fused_riccati.KERNEL] == 0
    assert x_plan.shape == (21, 12) and bool(torch.isfinite(x_plan).all())
