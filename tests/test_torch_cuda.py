"""The port's CUDA kernels on the card, against their plain PyTorch forms.

Every test here is marked ``cuda`` and skips without a card. The file imports
neither JAX nor ``quattro_tpu``, so it also runs on a machine that has only
PyTorch; ``tests/conftest.py`` configures JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are made from numpy seeds; float64, rtol 1e-9 (the kernel and the
plain form sum in different orders). The edge cases of the Riccati step
(``csrc/riccati_step.cuh``: each shape instance, horizons around its stage
ring's depth, K3's chunked staging) are also run in float32 and held
normwise, as ``chip_smoke.py`` holds the kernels: max |kernel - plain| over
max |plain| per tensor, float64 <= 1e-10 (K3 1e-9), float32 <= 1e-4.
"""

import ctypes
from functools import partial

import numpy as np
import pytest
import torch

from quattro_tpu_torch.control import make_quadrotor_mpc
from quattro_tpu_torch.ops import _build, blocktridiag, fused_linquad, fused_riccati, fused_rollout, fused_solve, smallchol
from quattro_tpu_torch.parallel import batch as batch_module
from quattro_tpu_torch.parallel import batched_ilqr_solve, batched_ilqr_solve_with_logs
from quattro_tpu_torch.solver import (
    CostExpansion, ILQRConfig, ilqr_solve, riccati_backward_associative, ilqr_solve_fused, line_search_batched2d, line_search_batched_fused,
    make_quadratic_cost, make_quadratic_final_cost, simulate, trajectory_cost,
)
from quattro_tpu_torch.solver.derivatives import quadratize_final_cost
from quattro_tpu_torch.solver.ilqr import _initial_rollout
from quattro_tpu_torch.systems import CartPoleField, QuadrotorField, make_discrete, quadrotor_dynamics
from quattro_tpu_torch.utils import timing

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


RING_DEPTH = 3  # kRingDepth of csrc/riccati_step.cuh: the stage ring's slots
STEP_SHAPES = [(12, 4), (4, 1), (16, 8), (1, 1), (7, 3)]  # both exact instances and the masked one
NORMWISE = {torch.float64: 1e-10, torch.float32: 1e-4}


def normwise(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def stable_stages(device, horizon, n, m, dtype, seed=0):
    """Random stages whose recursion stays bounded at any horizon (A contracts: radius about 0.9)."""
    rng = np.random.default_rng(seed)

    def spd(d):
        g = rng.standard_normal((horizon, d, d))
        return g @ np.swapaxes(g, -1, -2) / d + np.eye(d)

    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)
    a = 0.8 * np.eye(n) + 0.1 * rng.standard_normal((horizon, n, n)) / np.sqrt(n)
    exp = (rng.standard_normal((horizon, n)), rng.standard_normal((horizon, m)), spd(n), spd(m),
           0.1 * rng.standard_normal((horizon, m, n)))
    g = rng.standard_normal((n, n))
    return (t(a), t(0.1 * rng.standard_normal((horizon, n, m))), CostExpansion(*(t(e) for e in exp)),
            t(rng.standard_normal(n)), t(g @ g.T / n + np.eye(n)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("horizon", sorted({1, 2, RING_DEPTH - 1, RING_DEPTH, RING_DEPTH + 1, 100, 1024}))
@pytest.mark.parametrize("n, m", STEP_SHAPES)
def test_k1_step_edges_match_plain(cuda_device, n, m, horizon, dtype):
    """Each instance of the step, at horizons shorter than, equal to and longer than the stage ring."""
    data = stable_stages(cuda_device, horizon, n, m, dtype, seed=n * 100 + m * 10 + horizon)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_fused_single(*data, 1e-6)
    torch.cuda.synchronize()
    assert _build.launches[fused_riccati.KERNEL] == 1
    ref = fused_riccati.riccati_backward_fused_single_plain(*data, 1e-6)
    for name, o, r in zip(("k", "K", "V_x", "V_xx"), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert normwise(o, r) <= NORMWISE[dtype], name


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


GROUP_WIDTH = {"quadrotor": 4, "cartpole": 1}  # lanes per candidate in csrc/rollout_group.cuh


def group_rollout_inputs(device, plant, horizon, n_alpha, dtype, seed=0):
    """Seeded K2 inputs whose rollouts stay bounded at any horizon: the quadrotor near hover, the cart-pole near
    theta = 0, where its field pulls the pole back (started near theta = pi the pole turns over within a
    second, and float32 rounding alone then moves the plain form 2e-4 from float64); A step sizes from 1 down
    to 1e-3."""
    rng = np.random.default_rng(seed)
    n, m = (12, 4) if plant == "quadrotor" else (4, 1)
    values = (0.1 * rng.standard_normal(n), 0.1 * rng.standard_normal((horizon + 1, n)),
              (2.4525 if plant == "quadrotor" else 0.0) + 0.1 * rng.standard_normal((horizon, m)),
              0.05 * rng.standard_normal((horizon, m)), 0.05 * rng.standard_normal((horizon, m, n)),
              np.geomspace(1.0, 1e-3, n_alpha) if n_alpha > 1 else np.ones(1))
    return [torch.from_numpy(v).to(device=device, dtype=dtype) for v in values]


def group_dynamics(plant, method="rk4"):
    return make_discrete(QuadrotorField() if plant == "quadrotor" else CartPoleField(), 0.01, method)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("horizon", [1, 100, 257])
@pytest.mark.parametrize("n_alpha", ["1", "5", "6", "7", "8G+1", "300"])
@pytest.mark.parametrize("plant", ["quadrotor", "cartpole"])
def test_k2_group_edges_match_plain(cuda_device, plant, n_alpha, horizon, dtype):
    """Idle groups in a warp (A = 1, 5, 6, 7), several warps and CTAs (8 G + 1, 300), one step, and horizons
    that end inside and on the edge of a staged chunk; normwise against the plain form."""
    n_alpha = 8 * GROUP_WIDTH[plant] + 1 if n_alpha == "8G+1" else int(n_alpha)
    inputs = group_rollout_inputs(cuda_device, plant, horizon, n_alpha, dtype, seed=horizon + n_alpha)
    dyn = group_dynamics(plant)
    _build.reset_launches()
    out = fused_rollout.fused_feedback_rollouts(dyn, *inputs)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_rollout.KERNEL: 1}
    ref = fused_rollout.fused_feedback_rollouts_plain(dyn, *inputs)
    for name, o, r in zip(("cand_x", "cand_u"), out, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all()), name
        assert normwise(o, r) <= NORMWISE[dtype], name


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
@pytest.mark.parametrize(
    "plant, horizon, dtype",
    # Horizons past what K3 stages at once in 64 KB (quadrotor: 120 float64 / 240 float32 steps;
    # cart-pole: 819 float64 steps), so the rollouts stream the trajectory in three chunks.
    [("quadrotor", 130, torch.float64), ("quadrotor", 250, torch.float32), ("cartpole", 900, torch.float64)],
)
def test_k3_staging_in_chunks_matches_plain(cuda_device, plant, horizon, dtype):
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, plant, horizon)
    if dtype != torch.float64:
        cost = make_quadratic_cost(cost.q_mat.to(dtype), cost.r_mat.to(dtype), cost.x_ref.to(dtype),
                                   barrier_alpha=cost.barrier_alpha, barrier_beta=cost.barrier_beta)
        fcost = make_quadratic_final_cost(fcost.qf_mat.to(dtype), fcost.x_ref.to(dtype))
        x0, u0 = x0.to(dtype), u0.to(dtype)
    x_init = simulate(dyn, x0, u0)
    cost_init = trajectory_cost(cost, fcost, x_init, u0)
    args = (dyn, cost, fcost, x_init, u0, cost_init, 2, 0.0, 1e-6, (1.0, 0.5, 0.25, 0.1, 0.05, 0.01))
    _build.reset_launches()
    x, u, k, big_k, stats = fused_solve.fused_ilqr_solve_kernel(*args)
    torch.cuda.synchronize()
    assert _build.launches[fused_solve.KERNEL] == 1
    rx, ru, rk, rbig_k, rstats = fused_solve.fused_ilqr_solve_kernel_plain(*args)
    assert stats[0, 1:].tolist() == rstats[0, 1:].tolist() == [2.0, 0.0]
    bound = 1e-9 if dtype == torch.float64 else NORMWISE[dtype]
    for name, o, r in (("x", x, rx), ("u", u, ru), ("K", big_k, rbig_k), ("cost", stats[0, :1], rstats[0, :1])):
        assert normwise(o, r) <= bound, name
    scale = max(float(ru.abs().max()), float(rk.abs().max()), 1e-30)
    assert float((k - rk).abs().max()) <= bound * scale


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
    """One K3 launch per solve, which rolls out the warm start itself (no K2); same solve as seq + xla."""
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, "quadrotor", 16)
    _build.reset_launches()
    fused = ilqr_solve_fused(dyn, cost, fcost, x0, u0, ILQRConfig(tol=1e-3, max_iter=12))
    assert dict(_build.launches) == {fused_solve.KERNEL: 1}
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
    assert _build.launches[fused_riccati.KERNEL] == 0 and _build.launches[fused_rollout.KERNEL] == 0
    assert x_plan.shape == (21, 12) and bool(torch.isfinite(x_plan).all())


# The cells' limits on |u - u_ref| (bench_cuda/limits/): the scale a float32 solve's controls are held to.
U_GAP = {"quadrotor": 2.5e-3, "cartpole": 6e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("plant,horizon", [("quadrotor", 50), ("cartpole", 30)])
def test_k3_from_x0_matches_k2_cost_and_k3(cuda_device, plant, horizon, dtype):
    """K3 given x0 against the chain it replaces: K2's initial rollout, ``trajectory_cost`` and K3 given x_init.

    The prologue's rollout within 1e-12 (float64) / 1e-6 (float32) normwise of K2's and its cost within 1e-12 /
    1e-5 of ``trajectory_cost``'s (time order against a tree). The solve: float64 x, u, K and cost within 1e-12
    normwise, k on the controls' scale, the same iterations; float32 controls within the cell's u_gap limit.
    ``ilqr_solve_fused`` is the x0 launch alone.
    """
    dyn, cost, fcost, x0, u0 = solve_problem(cuda_device, plant, horizon)
    if dtype != torch.float64:
        cost = make_quadratic_cost(cost.q_mat.to(dtype), cost.r_mat.to(dtype), cost.x_ref.to(dtype),
                                   barrier_alpha=cost.barrier_alpha, barrier_beta=cost.barrier_beta)
        fcost = make_quadratic_final_cost(fcost.qf_mat.to(dtype), fcost.x_ref.to(dtype))
        x0, u0 = x0.to(dtype), u0.to(dtype)
    config = ILQRConfig(tol=1e-3 if plant == "quadrotor" else 1e-1, max_iter=6)
    trips = (config.max_iter, config.tol, config.reg, config.alphas)
    _build.reset_launches()
    x_init = _initial_rollout(dyn, x0, u0)
    cost_init = trajectory_cost(cost, fcost, x_init, u0)
    old = fused_solve.fused_ilqr_solve_kernel(dyn, cost, fcost, x_init, u0, cost_init, *trips)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_rollout.KERNEL: 1, fused_solve.KERNEL: 1}
    _build.reset_launches()
    new = fused_solve.fused_ilqr_solve_from_x0(dyn, cost, fcost, x0, u0, *trips)
    prologue = fused_solve.fused_ilqr_solve_from_x0(dyn, cost, fcost, x0, u0, 0, *trips[1:])
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_solve.KERNEL: 2}

    f64 = dtype == torch.float64
    assert normwise(prologue[0], x_init) <= (1e-12 if f64 else 1e-6)
    assert prologue[4][0, 1:].tolist() == [0.0, 0.0]
    assert normwise(prologue[4][0, 0], cost_init) <= (1e-12 if f64 else 1e-5)
    x, u, k, big_k, stats = new
    rx, ru, rk, rbig_k, rstats = old
    assert stats[0, 1:].tolist() == rstats[0, 1:].tolist()
    if f64:
        for name, o, r in (("x", x, rx), ("u", u, ru), ("K", big_k, rbig_k), ("cost", stats[0, 0], rstats[0, 0])):
            assert normwise(o, r) <= 1e-12, name
        scale = max(float(ru.abs().max()), float(rk.abs().max()), 1e-30)
        assert float((k - rk).abs().max()) <= 1e-12 * scale
    else:
        assert float((u - ru).abs().max()) <= U_GAP[plant]

    _build.reset_launches()
    sol = ilqr_solve_fused(dyn, cost, fcost, x0, u0, config)
    assert dict(_build.launches) == {fused_solve.KERNEL: 1}
    assert torch.equal(sol.x_seq, x) and torch.equal(sol.u_seq, u) and torch.equal(sol.big_k_seq, big_k)
    assert sol.iterations == int(stats[0, 1]) and float(sol.cost) == float(stats[0, 0])


def k3_problem(device, plant, dtype, warm):
    """``solve_problem`` at the cells' horizons in ``dtype``, with its tol: the quadrotor warm-started at hover
    thrust (``warm``, converged in 3 iterations at tol 1e-2) or from zero thrust (far from hover: 6 trips do not
    converge); the cart-pole from rest at tol 1e-1 (converged in 2)."""
    dyn, cost, fcost, x0, u0 = solve_problem(device, plant, 50 if plant == "quadrotor" else 30)
    cost = make_quadratic_cost(cost.q_mat.to(dtype), cost.r_mat.to(dtype), cost.x_ref.to(dtype),
                               barrier_alpha=cost.barrier_alpha, barrier_beta=cost.barrier_beta)
    fcost = make_quadratic_final_cost(fcost.qf_mat.to(dtype), fcost.x_ref.to(dtype))
    x0, u0 = x0.to(dtype), u0.to(dtype)
    if plant == "quadrotor" and warm:
        u0 = torch.full_like(u0, 2.4525)
    return (dyn, cost, fcost, x0, u0), 1e-2 if plant == "quadrotor" else 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["x_init", "x0"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("plant", ["quadrotor", "cartpole"])
def test_k3_leaving_at_done_equals_a_launch_of_its_iterations(cuda_device, plant, dtype, entry):
    """A launch of 6 trips whose solve converges in fewer leaves its loop there; its outputs equal, bit for bit,
    those of a launch given exactly that many trips, which has none to skip."""
    (dyn, cost, fcost, x0, u0), tol = k3_problem(cuda_device, plant, dtype, warm=True)
    config = ILQRConfig(tol=tol)
    if entry == "x0":
        solve = lambda budget: fused_solve.fused_ilqr_solve_from_x0(dyn, cost, fcost, x0, u0, budget, tol, config.reg,
                                                                    config.alphas)
    else:
        x_init = simulate(dyn, x0, u0)
        cost_init = trajectory_cost(cost, fcost, x_init, u0)
        solve = lambda budget: fused_solve.fused_ilqr_solve_kernel(dyn, cost, fcost, x_init, u0, cost_init, budget,
                                                                   tol, config.reg, config.alphas)
    out = solve(6)
    iterations, converged = out[4][0, 1:].tolist()
    assert 1 <= iterations < 6 and converged == 1.0
    exact = solve(int(iterations))
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, exact))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("plant,max_iter", [("quadrotor", 2), ("cartpole", 1)])
def test_k3_solve_that_needs_every_trip_runs_them_all(cuda_device, plant, max_iter, dtype):
    """From far from the optimum the solve needs its whole budget: ``max_iter`` iterations, none skipped."""
    problem, tol = k3_problem(cuda_device, plant, dtype, warm=False)
    timing.reset()
    with timing.tracing(True):
        sol = ilqr_solve_fused(*problem, ILQRConfig(tol=tol, max_iter=max_iter))
    counters = timing.counters()
    timing.reset()
    assert sol.iterations == max_iter and not sol.converged
    assert counters["mpc.trips"] == max_iter and counters["mpc.trips_skipped"] == 0


# ---------------------------------------------------------------------------
# The batched path: K4 (batched Riccati), K5 (linearize + quadratize, packed),
# K6/K7 (batched rollouts) and the batched solve.
# ---------------------------------------------------------------------------


def batched_stages(device, batch, horizon=7, seed=9, dtype=torch.float64):
    lanes = [riccati_stages(device, seed=seed + b, horizon=horizon) for b in range(batch)]
    a, b_mat, v_x, v_xx = (torch.stack([lane[i] for lane in lanes]).to(dtype) for i in (0, 1, 3, 4))
    exp = CostExpansion(*(torch.stack([lane[2][i] for lane in lanes]).to(dtype) for i in range(5)))
    return (a, b_mat), exp, v_x, v_xx


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["column", "batch2d", "auto", "packed"])
def test_k4_on_card_matches_plain(cuda_device, entry):
    batch = 128 if entry == "packed" else 5
    (a, b_mat), exp, v_x, v_xx = batched_stages(cuda_device, batch)
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6)
    _build.reset_launches()
    if entry == "column":
        out = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6)
    elif entry == "batch2d":
        out = fused_riccati.riccati_backward_batched_fused2d(a, b_mat, exp, v_x, v_xx, 1e-6)
    elif entry == "auto":
        out = fused_riccati.riccati_backward_batched_fused_auto(a, b_mat, exp, v_x, v_xx, 1e-6)
    else:
        packed = fused_riccati.pack_stages((a, b_mat, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u), 1, 8)
        out = fused_riccati.riccati_backward_batched_fused2d(
            None, None, None, v_x, v_xx, 1e-6, tile_s=1, block_t=2, packed_stage=packed, horizon=7)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: 1}
    _close_all(ref, out)


@pytest.mark.cuda
def test_k4_lanes_are_k1_bit_for_bit(cuda_device):
    """K4 runs K1's step unchanged (riccati_step.cuh), so each lane equals one K1 launch exactly."""
    (a, b_mat), exp, v_x, v_xx = batched_stages(cuda_device, 4)
    k, big_k = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6)
    for lane in range(4):
        k1 = fused_riccati.riccati_backward_fused_single(a[lane], b_mat[lane], [e[lane] for e in exp], v_x[lane],
                                                         v_xx[lane], 1e-6)
        assert torch.equal(k1[0], k[lane]) and torch.equal(k1[1], big_k[lane])


def batched_step_stages(device, batch, horizon, n, m, dtype=torch.float64, seed=20):
    lanes = [stable_stages(device, horizon, n, m, dtype, seed=seed + b) for b in range(batch)]
    a, b_mat, v_x, v_xx = (torch.stack([lane[i] for lane in lanes]) for i in (0, 1, 3, 4))
    exp = CostExpansion(*(torch.stack([lane[2][i] for lane in lanes]) for i in range(5)))
    return a, b_mat, exp, v_x, v_xx


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", sorted({1, 2, RING_DEPTH - 1, RING_DEPTH, RING_DEPTH + 1, 50}))
@pytest.mark.parametrize("n, m", [(12, 4), (4, 1), (7, 3)])
def test_k4_lanes_are_k1_bit_for_bit_at_each_instance(cuda_device, n, m, horizon):
    """K4 and K1 dispatch (n, m) to the same instance of the step: every lane equals K1 exactly."""
    a, b_mat, exp, v_x, v_xx = batched_step_stages(cuda_device, 3, horizon, n, m)
    k, big_k = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6)
    for lane in range(3):
        k1 = fused_riccati.riccati_backward_fused_single(a[lane], b_mat[lane], [e[lane] for e in exp], v_x[lane],
                                                         v_xx[lane], 1e-6)
        assert torch.equal(k1[0], k[lane]) and torch.equal(k1[1], big_k[lane])


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [None, torch.bfloat16], ids=["carry", "bf16"])
@pytest.mark.parametrize("n, m", [(12, 4), (4, 1)])
def test_k4_packed_reader_matches_plain(cuda_device, n, m, stream):
    """The packed layout (tile_s=1, h_pad=8) through the ring, in the carry type and as bfloat16:
    equal to the natural layout bit for bit and to the plain form on the same rounded inputs."""
    a, b_mat, exp, v_x, v_xx = batched_step_stages(cuda_device, 128, 5, n, m, dtype=torch.float32)
    natural = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6, stream_dtype=stream)
    packed = fused_riccati.pack_stages((a, b_mat, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u), 1, 8)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, 1e-6, tile_s=1,
                                                         stream_dtype=stream, packed_stage=packed, horizon=5)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: 1}
    assert all(torch.equal(o, r) for o, r in zip(out, natural))
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6, stream)
    for o, r in zip(out, ref):
        assert normwise(o, r) <= NORMWISE[torch.float32]


@pytest.mark.cuda
def test_k4_bf16_stream_on_card(cuda_device):
    """bfloat16 stage inputs: equal to the plain form on the same rounded inputs, near the exact gains."""
    (a, b_mat), exp, v_x, v_xx = batched_stages(cuda_device, 4, dtype=torch.float32)
    out = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6, stream_dtype=torch.bfloat16)
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6, torch.bfloat16)
    exact = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6)
    for o, r, e in zip(out, ref, exact):
        assert o.dtype == torch.float32
        assert float((o - r).abs().max() / r.abs().max()) < 1e-4
        assert 0.0 < float((o - e).abs().max() / e.abs().max()) < 5e-2


K4_WARPS = 4  # kWarps of csrc/fused_riccati_batched.cu: trajectories per CTA, one warp each
K4_RING = 4  # kDepth of csrc/fused_riccati_batched.cu: steps of stage data in the ring


def rounded_through(stages, stream):
    """(a, b, exp) as K4 reads them: the carry type, or rounded through ``stream`` (bfloat16)."""
    a, b_mat, exp = stages
    if stream is None:
        return a, b_mat, exp
    r = lambda x: x.to(stream).to(x.dtype)
    return r(a), r(b_mat), CostExpansion(*(r(e) for e in exp))


def assert_lanes_are_k1(stages, v_x, v_xx, out, lanes, stream=None):
    """The given lanes of K4's (k, K) equal K1 on those trajectories bit for bit (K4 widens bfloat16 exactly,
    so a bf16 lane equals K1 on the rounded inputs)."""
    a, b_mat, exp = rounded_through(stages, stream)
    for lane in lanes:
        k1 = fused_riccati.riccati_backward_fused_single(a[lane], b_mat[lane], [e[lane] for e in exp], v_x[lane],
                                                         v_xx[lane], 1e-6)
        assert torch.equal(k1[0], out[0][lane]) and torch.equal(k1[1], out[1][lane]), lane


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, stream", [(torch.float64, None), (torch.float32, None),
                                           (torch.float32, torch.bfloat16)], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 3, K4_WARPS + 1, 2049])
@pytest.mark.parametrize("n, m", [(12, 4), (4, 1), (7, 3), (16, 8)])
def test_k4_warp_lanes_are_k1_bit_for_bit(cuda_device, n, m, batch, dtype, stream):
    """Full CTAs and a tail CTA with idle warps, at each instance of the step, natural layout: the first,
    middle and last trajectories equal K1 bit for bit, the whole batch the plain form normwise."""
    a, b_mat, exp, v_x, v_xx = batched_step_stages(cuda_device, batch, 9, n, m, dtype=dtype)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6, stream_dtype=stream)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: 1}
    assert_lanes_are_k1((a, b_mat, exp), v_x, v_xx, out, sorted({0, batch // 2, batch - 1}), stream)
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6, stream)
    for o, r in zip(out, ref):
        assert normwise(o, r) <= NORMWISE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [None, torch.bfloat16], ids=["carry", "bf16"])
@pytest.mark.parametrize("tile_s, batch", [(1, 128), (1, 384), (8, 1024)])
@pytest.mark.parametrize("n, m", [(12, 4), (4, 1), (7, 3)])
def test_k4_packed_lanes_are_k1_bit_for_bit(cuda_device, n, m, tile_s, batch, stream):
    """The packed layout (tile_s 1 and 8, h_pad > H), where a CTA's warps fill one shared ring: equal to the
    natural layout bit for bit, and the first, middle and last lanes to K1."""
    horizon, h_pad = 5, 8
    a, b_mat, exp, v_x, v_xx = batched_step_stages(cuda_device, batch, horizon, n, m, dtype=torch.float32)
    natural = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6, stream_dtype=stream)
    packed = fused_riccati.pack_stages((a, b_mat, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u), tile_s, h_pad)
    _build.reset_launches()
    out = fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, 1e-6, tile_s=tile_s,
                                                         stream_dtype=stream, packed_stage=packed, horizon=horizon)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: 1}
    assert all(torch.equal(o, r) for o, r in zip(out, natural))
    assert_lanes_are_k1((a, b_mat, exp), v_x, v_xx, out, [0, batch // 2, batch - 1], stream)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["natural", "packed", "bf16"])
@pytest.mark.parametrize("horizon", sorted({0, 1, 2, K4_RING - 1, K4_RING, K4_RING + 1, 2 * K4_RING + 1, 16}))
def test_k4_horizons_around_the_ring(cuda_device, horizon, layout):
    """H = 0, 1, 2, around the ring's depth and 16 (the batched hybrid solve's tail windows are 1 and 16):
    shapes, the plain form, and lanes equal to K1."""
    dtype = torch.float32 if layout == "bf16" else torch.float64
    stream = torch.bfloat16 if layout == "bf16" else None
    a, b_mat, exp, v_x, v_xx = batched_step_stages(cuda_device, 128, horizon, 12, 4, dtype=dtype)
    if layout == "packed":
        packed = fused_riccati.pack_stages((a, b_mat, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u), 1,
                                           horizon + 2)
        out = fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, 1e-6, tile_s=1, block_t=1,
                                                             packed_stage=packed, horizon=horizon)
    else:
        out = fused_riccati.riccati_backward_batched_fused(a, b_mat, exp, v_x, v_xx, 1e-6, stream_dtype=stream)
    torch.cuda.synchronize()
    assert out[0].shape == (128, horizon, 4) and out[1].shape == (128, horizon, 4, 12)
    if horizon == 0:
        return
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, exp, v_x, v_xx, 1e-6, stream)
    for o, r in zip(out, ref):
        assert normwise(o, r) <= NORMWISE[dtype]
    assert_lanes_are_k1((a, b_mat, exp), v_x, v_xx, out, [0, 77, 127], stream)


def quad_linquad_problem(device, batch=128, horizon=7, seed=4, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
    cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0)
    xs = t(0.1 * rng.standard_normal((batch, horizon + 1, 12)))
    us = t(2.4 + 0.1 * rng.standard_normal((batch, horizon, 4)))
    us[0, 0, 0] = -0.2  # the barrier's other half-line
    return make_discrete(QuadrotorField(), 0.01, "rk4"), cost, xs, us


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_on_card_matches_plain(cuda_device, dtype):
    dyn, cost, xs, us = quad_linquad_problem(cuda_device, dtype=dtype)
    _build.reset_launches()
    out = fused_linquad.linquad_batched_fused(dyn, cost, xs, us, tile_s=1, block_t=2)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_linquad.KERNEL: 1}
    ref = fused_linquad.linquad_batched_fused_plain(dyn, cost, xs, us, tile_s=1, block_t=2)
    bound = RTOL if dtype == torch.float64 else 1e-4
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) <= bound * max(float(r.abs().max()), 1.0)


@pytest.mark.cuda
def test_k5_to_k4_chain_equals_unpacked_k4(cuda_device):
    """K4 reads K5's packed tensors in place: the gains equal K4 on the unpacked stages exactly."""
    dyn, cost, xs, us = quad_linquad_problem(cuda_device, horizon=6)
    packed = fused_linquad.linquad_batched_fused(dyn, cost, xs, us, tile_s=1, block_t=4)
    v_x = xs[:, -1].clone()
    v_xx = torch.eye(12, dtype=xs.dtype, device=cuda_device).expand(128, 12, 12).contiguous()
    chain = fused_riccati.riccati_backward_batched_fused2d(
        None, None, None, v_x, v_xx, 1e-6, tile_s=1, block_t=4, packed_stage=packed, horizon=6)
    a, b_mat, l_xx, l_uu, l_ux, l_x, l_u = (
        fused_riccati.unpack_stage(x, 128, 6, tail, 1) for x, tail in zip(packed, fused_riccati.stage_shapes(12, 4)))
    direct = fused_riccati.riccati_backward_batched_fused(a, b_mat, CostExpansion(l_x, l_u, l_xx, l_uu, l_ux),
                                                          v_x, v_xx, 1e-6)
    assert all(torch.equal(c, d) for c, d in zip(chain, direct))


def linquad_problem(device, plant, method, batch, horizon, dtype, seed=5):
    """A seeded batch for K5 at either plant: states near the operating point (the quadrotor's pitch up to
    about 1.2 rad, where tan and 1/cos(pitch) grow), controls on both sides of the barrier."""
    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    if plant == "quadrotor":
        x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
        cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0)
        xs = 0.1 * rng.standard_normal((batch, horizon + 1, 12))
        xs[:, :, 7] = 1.2 * np.tanh(3.0 * xs[:, :, 7])
        us = 2.4 + 0.5 * rng.standard_normal((batch, horizon, 4))
        field = QuadrotorField()
    else:
        cost = make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4), barrier_alpha=10.0)
        xs = np.array([0.3, 0.5, 0.6, 1.5]) * rng.standard_normal((batch, horizon + 1, 4))
        us = 5.0 * rng.standard_normal((batch, horizon, 1))
        field = CartPoleField()
    return make_discrete(field, 0.01, method), cost, t(xs), t(us)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("plant", ["quadrotor", "cartpole"])
def test_k5_plants_and_pads_match_plain(cuda_device, plant, method, dtype):
    """Both plants, Euler and RK4, pad steps (h_pad > H) and step tiles that straddle the pad: against the
    plain form (normwise, as chip_smoke.py holds K5), then K5 -> K4 equal to K4 on the unpacked stages."""
    batch, horizon, tile_s, block_t = 256, 9, 2, 4  # h_pad 12: 3 pad steps, then 9 real ones
    dyn, cost, xs, us = linquad_problem(cuda_device, plant, method, batch, horizon, dtype)
    _build.reset_launches()
    out = fused_linquad.linquad_batched_fused(dyn, cost, xs, us, tile_s=tile_s, block_t=block_t)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {fused_linquad.KERNEL: 1}
    ref = fused_linquad.linquad_batched_fused_plain(dyn, cost, xs, us, tile_s=tile_s, block_t=block_t)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.shape[0] == batch // (tile_s * 128) * 12
        assert normwise(o, r) <= NORMWISE[dtype]
    n, m = xs.shape[-1], us.shape[-1]
    v_x = xs[:, -1].clone()
    v_xx = torch.eye(n, dtype=dtype, device=cuda_device).expand(batch, n, n).contiguous()
    chain = fused_riccati.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, 1e-6, tile_s=tile_s,
                                                           block_t=block_t, packed_stage=out, horizon=horizon)
    a, b_mat, l_xx, l_uu, l_ux, l_x, l_u = (fused_riccati.unpack_stage(x, batch, horizon, tail, tile_s)
                                            for x, tail in zip(out, fused_riccati.stage_shapes(n, m)))
    direct = fused_riccati.riccati_backward_batched_fused(a, b_mat, CostExpansion(l_x, l_u, l_xx, l_uu, l_ux),
                                                          v_x, v_xx, 1e-6)
    assert all(torch.equal(c, d) for c, d in zip(chain, direct))


@pytest.mark.cuda
@pytest.mark.parametrize("horizon, block_t", [(1, 2), (2, 4), (3, 1), (5, 8)])
def test_k5_short_horizons_match_plain(cuda_device, horizon, block_t):
    """Horizons shorter than a CTA's step tile, with and without pad steps."""
    dyn, cost, xs, us = linquad_problem(cuda_device, "quadrotor", "rk4", 128, horizon, torch.float64)
    out = fused_linquad.linquad_batched_fused(dyn, cost, xs, us, tile_s=1, block_t=block_t)
    ref = fused_linquad.linquad_batched_fused_plain(dyn, cost, xs, us, tile_s=1, block_t=block_t)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        if r.numel():
            assert normwise(o, r) <= NORMWISE[torch.float64]


def batched_rollout_inputs(device, batch=5, seed=6, horizon=12):
    values = [rollout_inputs(device, seed=seed + b, horizon=horizon) for b in range(batch)]
    x0, x_ref, u_ref, k, big_k = (torch.stack([v[i] for v in values]) for i in range(5))
    return x0, x_ref, u_ref, k, big_k, values[0][5]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["batched", "batched2d"])
def test_k6_k7_on_card_match_plain_and_k2(cuda_device, entry):
    inputs = batched_rollout_inputs(cuda_device)
    dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
    fn = getattr(fused_rollout, f"fused_feedback_rollouts_{entry}")
    name = fused_rollout.BATCHED_KERNEL if entry == "batched" else fused_rollout.BATCHED2D_KERNEL
    _build.reset_launches()
    out = fn(dyn, *inputs)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {name: 1}
    assert out[0].shape == (6, 5, 13, 12) and out[1].shape == (6, 5, 12, 4)
    _close_all(fused_rollout.fused_feedback_rollouts_batched_plain(dyn, *inputs), out)
    for lane in range(5):  # each lane runs K2's per-thread body
        k2 = fused_rollout.fused_feedback_rollouts(dyn, *(x[lane] for x in inputs[:5]), inputs[5])
        assert torch.equal(k2[0], out[0][:, lane]) and torch.equal(k2[1], out[1][:, lane])


@pytest.mark.cuda
@pytest.mark.parametrize("batch, n_alpha", [(1, 6), (3, 9), (2049, 6)])
@pytest.mark.parametrize("plant", ["quadrotor", "cartpole"])
def test_k6_k7_group_lanes_are_k2_bit_for_bit(cuda_device, plant, batch, n_alpha):
    """One warp per trajectory (two for the quadrotor at A = 9), H = 20 over three staged chunks: against the
    plain form, and the first, middle and last trajectories equal K2 on them bit for bit."""
    lanes = [group_rollout_inputs(cuda_device, plant, 20, n_alpha, torch.float64, seed=b) for b in range(batch)]
    inputs = [torch.stack([lane[i] for lane in lanes]) for i in range(5)] + [lanes[0][5]]
    dyn = group_dynamics(plant)
    for entry, name in (("batched", fused_rollout.BATCHED_KERNEL), ("batched2d", fused_rollout.BATCHED2D_KERNEL)):
        _build.reset_launches()
        out = getattr(fused_rollout, f"fused_feedback_rollouts_{entry}")(dyn, *inputs)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {name: 1}
        _close_all(fused_rollout.fused_feedback_rollouts_batched_plain(dyn, *inputs), out)
        for lane in sorted({0, batch // 2, batch - 1}):
            k2 = fused_rollout.fused_feedback_rollouts(dyn, *(x[lane] for x in inputs[:5]), inputs[5])
            assert torch.equal(k2[0], out[0][:, lane]) and torch.equal(k2[1], out[1][:, lane]), (entry, lane)


@pytest.mark.cuda
def test_batched_kernels_refuse_unknown_plants_and_costs(cuda_device):
    lam = make_discrete(lambda x, u: quadrotor_dynamics(x, u), 0.01, "rk4")
    dyn, cost, xs, us = quad_linquad_problem(cuda_device)
    _build.reset_launches()
    with pytest.raises(ValueError, match="quadrotor"):
        fused_linquad.linquad_batched_fused(lam, cost, xs, us, tile_s=1)
    with pytest.raises(ValueError, match="make_quadratic_cost"):
        fused_linquad.linquad_batched_fused(dyn, lambda x, u: cost(x, u), xs, us, tile_s=1)
    inputs = batched_rollout_inputs(cuda_device, batch=2)
    for fn in (fused_rollout.fused_feedback_rollouts_batched, fused_rollout.fused_feedback_rollouts_batched2d):
        with pytest.raises(ValueError, match="quadrotor"):
            fn(lam, *inputs)
    assert sum(_build.launches.values()) == 0


def batched_cartpole(device, batch=4, horizon=10):
    rng = np.random.default_rng(2)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    cost = make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4))
    fcost = make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t([0.0] * 4))
    return dyn, cost, fcost, t(0.2 * rng.standard_normal((batch, 4))), t(np.zeros((batch, horizon, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("linesearch", ["xla", "fused"])
def test_batched_solve_launches_k4_and_k7_once_per_trip(cuda_device, linesearch):
    """One K4 launch per trip (and one K7 with linesearch="fused"); the same solve as "vmap"
    (JAX's tolerances for its two backends: cost rtol 1e-9, u atol 1e-8)."""
    dyn, cost, fcost, x0s, u0s = batched_cartpole(cuda_device)
    cfg = ILQRConfig(tol=0.0, max_iter=3, linesearch=linesearch)
    _build.reset_launches()
    fused = batched_ilqr_solve(dyn, cost, fcost, x0s, u0s, cfg, riccati_backend="fused")
    torch.cuda.synchronize()
    trips = int(fused.iterations.max())
    expected = {fused_riccati.BATCHED_KERNEL: trips}
    if linesearch == "fused":
        expected[fused_rollout.BATCHED_KERNEL] = trips
    assert trips >= 1 and dict(_build.launches) == expected
    ref = batched_ilqr_solve(dyn, cost, fcost, x0s, u0s, cfg._replace(linesearch="xla"), riccati_backend="vmap")
    assert torch.equal(fused.iterations, ref.iterations) and torch.equal(fused.converged, ref.converged)
    np.testing.assert_allclose(fused.cost.cpu().numpy(), ref.cost.cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(fused.u_seq.cpu().numpy(), ref.u_seq.cpu().numpy(), atol=1e-8)


def bench_quad_batch(device, batch, dtype, horizon=50, seed=16):
    """The batch cell's quadrotor problem: starts drawn in the collection's envelope (x, y, z, roll, pitch, yaw),
    at rest; every rotor at hover thrust on every step."""
    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    lower, upper = np.array([-0.3, -0.3, 0.49, -0.2, -0.2, -0.5]), np.array([0.3, 0.3, 0.51, 0.2, 0.2, 0.5])
    x0 = np.zeros((batch, 12))
    x0[:, [0, 1, 2, 6, 7, 8]] = lower + (upper - lower) * rng.random((batch, 6))
    x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
    return (make_discrete(QuadrotorField(), 0.01, "rk4"),
            make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0),
            make_quadratic_final_cost(t(10.0 * np.asarray(Q)), x_ref), t(x0), t(np.full((batch, horizon, 4), 2.4525)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_route_solve_matches_the_vmap_route(cuda_device, monkeypatch, dtype):
    """The batch cell's solve at B = 2,048, H = 50: one K5, one packed K4 and one K7 per trip, against the same
    solve on ``vmap`` derivatives and natural K4. float64: equal iterations, flags and accepts (step sizes, every
    trip), u within 1e-10; float32: cost within 1e-4 relative, iterations equal on at least 99 % of lanes."""
    prob = bench_quad_batch(cuda_device, 2048, dtype)
    cfg = ILQRConfig(tol=1e-3, max_iter=8, linesearch="fused")
    _build.reset_launches()
    got, got_logs = batched_ilqr_solve_with_logs(*prob, cfg, riccati_backend="fused")
    torch.cuda.synchronize()
    trips = int(got.iterations.max())
    assert trips >= 2 and dict(_build.launches) == {
        fused_linquad.KERNEL: trips, fused_riccati.BATCHED_KERNEL: trips, fused_rollout.BATCHED_KERNEL: trips}
    monkeypatch.setattr(batch_module, "_linquad_applies", lambda *args: False)
    _build.reset_launches()
    ref, ref_logs = batched_ilqr_solve_with_logs(*prob, cfg, riccati_backend="fused")
    torch.cuda.synchronize()
    assert fused_linquad.KERNEL not in _build.launches
    if dtype == torch.float64:
        assert torch.equal(got.iterations, ref.iterations) and torch.equal(got.converged, ref.converged)
        assert torch.equal(got_logs.found_update, ref_logs.found_update) and torch.equal(got_logs.alpha, ref_logs.alpha)
        assert float((got.u_seq - ref.u_seq).abs().max()) <= 1e-10
    else:
        assert float(((got.cost - ref.cost).abs() / ref.cost.abs()).max()) <= 1e-4
        assert float((got.iterations == ref.iterations).double().mean()) >= 0.99


@pytest.mark.cuda
def test_k5_to_k4_trip_at_the_cell_width(cuda_device):
    """One trip's K5 -> packed K4 at the batch cell's width (B = 65,536, H = 50, float32, the warm start's rollout)
    against its plain chain (the ``vmap`` derivatives packed, plain K4 on them unpacked): each packed stage tensor
    and the gains within 1e-4 normwise."""
    dyn, cost, fcost, x0, us = bench_quad_batch(cuda_device, 65536, torch.float32)
    xs = torch.func.vmap(partial(simulate, dyn))(x0, us)
    packed = fused_linquad.linquad_batched_fused(dyn, cost, xs, us)
    plain = fused_linquad.linquad_batched_fused_plain(dyn, cost, xs, us)
    assert all(normwise(o, r) <= NORMWISE[torch.float32] for o, r in zip(packed, plain))
    fexp = torch.func.vmap(partial(quadratize_final_cost, fcost))(xs[:, -1])
    chain = fused_riccati.riccati_backward_batched_fused2d(None, None, None, fexp.v_x, fexp.v_xx, 1e-6,
                                                           packed_stage=packed, horizon=50)
    del packed
    tile_s = fused_riccati.default_tile_s(65536)
    a, b_mat, l_xx, l_uu, l_ux, l_x, l_u = (fused_riccati.unpack_stage(x, 65536, 50, tail, tile_s)
                                            for x, tail in zip(plain, fused_riccati.stage_shapes(12, 4)))
    ref = fused_riccati.riccati_backward_batched_fused_plain(a, b_mat, CostExpansion(l_x, l_u, l_xx, l_uu, l_ux),
                                                             fexp.v_x, fexp.v_xx, 1e-6)
    torch.cuda.synchronize()
    assert all(normwise(c, r) <= NORMWISE[torch.float32] for c, r in zip(chain, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("exact_fallback", [False, True])
def test_batched_hybrid_lanes_are_the_single_solves(cuda_device, exact_fallback):
    """``batched_hybrid_ilqr_solve`` on the card, float64, a small random predictor (state_stride 2): one K4 over
    the tail windows and one K7 per trip, one more of each per trip whose fallback ran (forced to K4); each lane
    its single ``hybrid_ilqr_solve`` (iterations and flags equal, cost rtol 1e-9, u atol 1e-8)."""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve
    from quattro_tpu_torch.solver import hybrid_ilqr_solve

    horizon, window, batch = 24, 4, 4
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=cuda_device)
    x_ref = t([0.0, 0.0, 0.5] + [0.0] * 9)
    dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
    cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0)
    fcost = make_quadratic_final_cost(t([10.0 * q for q in Q]), x_ref)
    rng = np.random.default_rng(12)
    x0s = x_ref + t(0.05 * rng.standard_normal((batch, 12)))
    x0s[:2, 2] = t(0.2 + 0.3 * rng.random(2))
    u0s = t(np.full((batch, horizon, 4), 2.4525))
    pred = GainPredictor.create(12, 52, window, horizon - window, d_model=16, nhead=2, num_decoder_layers=1,
                                dim_feedforward=32, max_seq_len=64, state_stride=2, device=cuda_device)
    cfg = ILQRConfig(tol=1e-1, max_iter=3, linesearch="fused")
    _build.reset_launches()
    sol = batched_hybrid_ilqr_solve(dyn, cost, fcost, pred.predict_fn(), window, x0s, u0s, x_ref, cfg, x_ref,
                                    exact_fallback=exact_fallback, riccati_backend="fused")
    torch.cuda.synchronize()
    counts, trips = dict(_build.launches), int(sol.iterations.max())
    k4, k7 = counts.get(fused_riccati.BATCHED_KERNEL, 0), counts.get(fused_rollout.BATCHED_KERNEL, 0)
    assert trips >= 1 and k4 == k7 and trips <= k4 <= 2 * trips and (k4 > trips) == exact_fallback
    for b in range(batch):
        one = hybrid_ilqr_solve(dyn, cost, fcost, pred.predict_fn(), window, x0s[b], u0s[b], x_ref, cfg, x_ref,
                                exact_fallback=exact_fallback)
        assert int(sol.iterations[b]) == one.iterations and bool(sol.converged[b]) == one.converged
        np.testing.assert_allclose(float(sol.cost[b]), float(one.cost), rtol=1e-9)
        np.testing.assert_allclose(sol.u_seq[b].cpu().numpy(), one.u_seq.cpu().numpy(), rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("exact_fallback", [False, True])
def test_batched_hybrid_wide_state_tail_runs_without_k4(cuda_device, exact_fallback):
    """n = 18 > 16, beyond K4: the tail window runs the sequential pass under ``vmap`` on the card (no K4
    launch, no error), and each lane is its single ``hybrid_ilqr_solve`` (iterations and flags equal, cost rtol
    1e-9, u atol 1e-8)."""
    from quattro_tpu_torch.models import DataNormalizer, GainPredictor
    from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve
    from quattro_tpu_torch.solver import hybrid_ilqr_solve

    n, m, horizon, window, batch = 18, 2, 12, 3, 3
    rng = np.random.default_rng(7)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=cuda_device)
    a, b = t(np.eye(n) + 0.05 * rng.standard_normal((n, n))), t(0.1 * rng.standard_normal((n, m)))
    x_ref = t(0.1 * rng.standard_normal(n))
    dyn = lambda x, u: a @ x + b @ u
    cost = make_quadratic_cost(t(np.ones(n)), t(np.full(m, 0.1)), x_ref)
    fcost = make_quadratic_final_cost(t(np.full(n, 10.0)), x_ref)
    x0s, u0s = t(rng.standard_normal((batch, n))), t(np.zeros((batch, horizon, m)))
    # Head gains of about 1e-3: an ulp between the batched and the unbatched forward stays far below 1e-8 in u.
    c = m * (1 + n)
    norm = DataNormalizer(torch.zeros(n), torch.ones(n), torch.zeros(c), torch.full((c,), 1e-3))
    pred = GainPredictor.create(n, c, window, horizon - window, d_model=16, nhead=2, num_decoder_layers=1,
                                dim_feedforward=32, max_seq_len=64, normalizer=norm, state_stride=2,
                                device=cuda_device)
    cfg = ILQRConfig(tol=1e-4, max_iter=3)
    _build.reset_launches()
    sol = batched_hybrid_ilqr_solve(dyn, cost, fcost, pred.predict_fn(), window, x0s, u0s, x_ref, cfg,
                                    exact_fallback=exact_fallback, riccati_backend="vmap")
    torch.cuda.synchronize()
    assert dict(_build.launches).get(fused_riccati.BATCHED_KERNEL, 0) == 0
    for lane in range(batch):
        one = hybrid_ilqr_solve(dyn, cost, fcost, pred.predict_fn(), window, x0s[lane], u0s[lane], x_ref, cfg,
                                exact_fallback=exact_fallback)
        assert int(sol.iterations[lane]) == one.iterations and bool(sol.converged[lane]) == one.converged
        np.testing.assert_allclose(float(sol.cost[lane]), float(one.cost), rtol=1e-9)
        np.testing.assert_allclose(sol.u_seq[lane].cpu().numpy(), one.u_seq.cpu().numpy(), rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_vmap_backend_routes_pinned_fused_lanes_to_k4_and_k7(cuda_device):
    """A pinned riccati="fused"/linesearch="fused" under "vmap" reaches the batched kernels, never K1 or K2."""
    dyn, cost, fcost, x0s, u0s = batched_cartpole(cuda_device)
    cfg = ILQRConfig(tol=0.0, max_iter=2, riccati="fused", linesearch="fused")
    _build.reset_launches()
    sol = batched_ilqr_solve(dyn, cost, fcost, x0s, u0s, cfg, riccati_backend="vmap")
    torch.cuda.synchronize()
    trips = int(sol.iterations.max())
    assert trips >= 1
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: trips, fused_rollout.BATCHED_KERNEL: trips}


@pytest.mark.cuda
def test_line_search_batched2d_on_card_is_the_fused_one(cuda_device):
    """Both batched line searches launch one kernel (counted K6 and K7) and select alike."""
    dyn, cost, fcost, x0s, u0s = batched_cartpole(cuda_device)
    xs = torch.stack([simulate(dyn, x, u) for x, u in zip(x0s, u0s)])
    cs = torch.stack([trajectory_cost(cost, fcost, x, u) for x, u in zip(xs, u0s)])
    rng = np.random.default_rng(3)
    k = torch.as_tensor(0.5 * rng.standard_normal((4, 10, 1)), device=cuda_device)
    big_k = torch.as_tensor(0.5 * rng.standard_normal((4, 10, 1, 4)), device=cuda_device)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.05, 0.01], dtype=torch.float64, device=cuda_device)
    args = (dyn, cost, fcost, x0s, xs, u0s, k, big_k, cs, alphas)
    _build.reset_launches()
    got = line_search_batched2d(*args)
    assert dict(_build.launches) == {fused_rollout.BATCHED2D_KERNEL: 1}
    ref = line_search_batched_fused(*args)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# ---------------------------------------------------------------------------
# The associative Riccati form and the KKT route: K8 (batched SPD solve) and
# K9 (block-tridiagonal SpMV).
# ---------------------------------------------------------------------------


def spd_systems(device, batch, m, r, dtype, seed=12):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((batch, m, m))
    a = w @ np.swapaxes(w, -1, -2) + 2.0 * np.eye(m)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return t(a), t(rng.standard_normal((batch, m, r)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch, m, r", [(301, 4, 13), (1, 1, 2), (1000, 8, 5)])
def test_k8_on_card_matches_plain(cuda_device, batch, m, r, dtype):
    a, b = spd_systems(cuda_device, batch, m, r, dtype)
    _build.reset_launches()
    out = smallchol.batched_cholesky_solve_fused(a, b)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {smallchol.KERNEL: 1}
    ref = smallchol.batched_cholesky_solve_plain(a, b)
    bound = RTOL if dtype == torch.float64 else 1e-4
    assert out.shape == (batch, m, r)
    assert float((out - ref).abs().max() / ref.abs().max()) <= bound


@pytest.mark.cuda
def test_k8_on_card_refuses_m9_and_other_dtypes(cuda_device):
    _build.reset_launches()
    with pytest.raises(ValueError, match="m <= 8"):
        smallchol.batched_cholesky_solve_fused(*spd_systems(cuda_device, 4, 9, 2, torch.float64))
    with pytest.raises(ValueError, match="float32 or float64"):
        smallchol.batched_cholesky_solve_fused(*spd_systems(cuda_device, 4, 3, 2, torch.float16))
    assert sum(_build.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("num_blocks, n", [(1, 12), (7, 12), (1000, 5)])
def test_k9_on_card_matches_plain(cuda_device, num_blocks, n, dtype):
    rng = np.random.default_rng(num_blocks)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=cuda_device)
    mat = blocktridiag.BlockTridiagonal(t(rng.standard_normal((num_blocks, n, n))),
                                        t(rng.standard_normal((num_blocks - 1, n, n))))
    x = t(rng.standard_normal((num_blocks, n)))
    _build.reset_launches()
    out = blocktridiag.btd_matvec(mat, x)
    res = blocktridiag.kkt_residual(mat, x, out)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {blocktridiag.KERNEL: 2}
    ref = blocktridiag.btd_matvec_plain(mat, x)
    bound = RTOL if dtype == torch.float64 else 1e-4
    assert float((out - ref).abs().max() / ref.abs().max()) <= bound
    assert float(res.max()) == 0.0


_TILE_HELPERS = {  # C helper: (source, argtypes)
    "qt_btd_matvec_tile": (blocktridiag.KERNEL, [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]),
    "qt_batched_cholesky_tile": (smallchol.KERNEL, [ctypes.c_int] * 3),
}


def _tile(symbol, *args):
    """Tile size the kernel's launch takes, from its C helper."""
    source, argtypes = _TILE_HELPERS[symbol]
    return _build.bind(source, symbol, ctypes.c_int, argtypes)(*args)


def _normwise(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [4, 12, 5, 13, 64, 65, 130],
                         ids=["n4-templated", "n12-templated", "n5-generic", "n13-generic", "n64-over-48KB",
                              "n65-rows", "n130-rows"])
def test_k9_tile_edges_match_plain(cuda_device, n, dtype):
    """N = 1, 2, one short of / at / one past the widest tile T, 1,025, and full tiles of T with a ragged end;
    y and the fused residual each in one launch, against the plain form. n = 64 in float64 takes one block
    row per CTA, with more than 48 KB of shared memory; n = 65 and 130 are too wide for the tile and take the
    kernel that reads the band from device memory (130: more entries than threads)."""
    code = 0 if dtype == torch.float32 else 1
    widest = _tile("qt_btd_matvec_tile", code, 10**9, n, 0)
    full = widest * torch.cuda.get_device_properties(cuda_device).multi_processor_count
    bound = RTOL if dtype == torch.float64 else 1e-4
    for num_blocks in sorted({1, 2, max(widest - 1, 1), widest, widest + 1, 1025, full + 1, 3 * full - 1}):
        rng = np.random.default_rng(num_blocks * 100 + n)
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=cuda_device)
        mat = blocktridiag.BlockTridiagonal(t(rng.standard_normal((num_blocks, n, n))),
                                            t(rng.standard_normal((num_blocks - 1, n, n))))
        x, rhs = t(rng.standard_normal((num_blocks, n))), t(rng.standard_normal((num_blocks, n)))
        _build.reset_launches()
        out = blocktridiag.btd_matvec(mat, x)
        res = blocktridiag.kkt_residual(mat, x, rhs)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {blocktridiag.KERNEL: 2}
        ref = blocktridiag.btd_matvec_plain(mat, x)
        assert out.shape == (num_blocks, n) and res.shape == (num_blocks,)
        assert _normwise(out, ref) <= bound, num_blocks
        assert _normwise(res, (ref - rhs).abs().amax(-1)) <= bound, num_blocks


@pytest.mark.cuda
def test_k9_refuses_empty_blocks_and_mismatched_rhs(cuda_device):
    t = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=cuda_device)
    _build.reset_launches()
    with pytest.raises(ValueError, match="n >= 1"):
        blocktridiag.btd_matvec(blocktridiag.BlockTridiagonal(t(2, 0, 0), t(1, 0, 0)), t(2, 0))
    with pytest.raises(ValueError, match="expected"):
        blocktridiag.kkt_residual(blocktridiag.BlockTridiagonal(t(3, 4, 4), t(2, 4, 4)), t(3, 4), t(2, 4))
    assert sum(_build.launches.values()) == 0


@pytest.mark.cuda
def test_kkt_route_on_card_matches_cpu(cuda_device):
    """build_lqr_kkt -> btd_solve -> recover_primal -> kkt_residual on the card against the CPU, with the
    tensors as the route makes them (strided ones among them, which K9 copies); one K9 launch."""
    rng = np.random.default_rng(5)
    horizon, n, m = 40, 12, 4
    w, wf = rng.standard_normal((horizon, n, n)), rng.standard_normal((n, n))
    stages = (np.eye(n) + 0.01 * rng.standard_normal((horizon, n, n)), 0.05 * rng.standard_normal((horizon, n, m)),
              (rng.standard_normal((horizon, n)), rng.standard_normal((horizon, m)),
               0.1 * w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(n), np.broadcast_to(np.eye(m), (horizon, m, m)).copy(),
               0.01 * rng.standard_normal((horizon, m, n))),
              rng.standard_normal(n), wf @ wf.T + np.eye(n))

    def route(device):
        t = lambda v: torch.as_tensor(v, device=device)
        a, b, exp, v_x, v_xx = stages
        system = blocktridiag.build_lqr_kkt(t(a), t(b), CostExpansion(*(t(e) for e in exp)), t(v_x), t(v_xx), 1e-9)
        lam = blocktridiag.btd_solve(system.matrix, system.rhs)
        return system, lam, blocktridiag.recover_primal(system, lam), blocktridiag.kkt_residual(
            system.matrix, lam, system.rhs)

    cpu = route("cpu")
    _build.reset_launches()
    card = route(cuda_device)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {blocktridiag.KERNEL: 1}
    _close_all(cpu[1:3], card[1:3])
    scale = float(cpu[0].rhs.abs().max())
    assert float(card[3].max()) < 1e-8 * scale
    np.testing.assert_allclose(card[3].cpu().numpy(), cpu[3].numpy(), rtol=0, atol=1e-12 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m, r", [(m, r) for m in (1, 4, 8) for r in (1, 13, 25, 40)]
                         + [(8, 2048), (8, 2049), (4, 2049), (1, 4099)])
def test_k8_tile_edges_match_plain(cuda_device, m, r, dtype):
    """batch = 1, S - 1, S, S + 1 and 4 S + 3 (the ragged last tile) for the tile of S systems K8 takes;
    r = 2048 at m = 8 takes one system per CTA, with more than 48 KB of shared memory; r > 2048 is too wide
    for the tile and takes the kernel that solves chunks of columns in device memory (4,099: a ragged
    chunk)."""
    tile = _tile("qt_batched_cholesky_tile", 0 if dtype == torch.float32 else 1, m, r)
    bound = RTOL if dtype == torch.float64 else 1e-4
    for batch in sorted({1, max(tile - 1, 1), tile, tile + 1, 4 * tile + 3}):
        a, b = spd_systems(cuda_device, batch, m, r, dtype, seed=batch + 10 * m + r)
        _build.reset_launches()
        out = smallchol.batched_cholesky_solve_fused(a, b)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {smallchol.KERNEL: 1}
        assert out.shape == (batch, m, r)
        assert _normwise(out, smallchol.batched_cholesky_solve_plain(a, b)) <= bound, batch


@pytest.mark.cuda
def test_k8_reads_an_unaligned_view(cuda_device):
    """A view that starts off a 16-byte boundary takes the single loads of the unaligned head."""
    a, b = spd_systems(cuda_device, 301, 4, 13, torch.float32)
    a_buf = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)
    b_buf = torch.cat([b.new_zeros(3), b.reshape(-1)])[3:].view(b.shape)
    assert a_buf.data_ptr() % 16 and b_buf.data_ptr() % 16
    out = smallchol.batched_cholesky_solve_fused(a_buf, b_buf)
    assert _normwise(out, smallchol.batched_cholesky_solve_plain(a, b)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
def test_associative_pass_on_card_matches_cpu(cuda_device, batch):
    """Two K8 launches per pass (stage elements, gains); the card against the same call on the CPU."""
    horizon = 37
    rng = np.random.default_rng(21)
    lanes = [riccati_stages("cpu", seed=30 + i, horizon=horizon) for i in range(3)]
    data = lanes[0] if not batch else (
        torch.stack([lane[0] for lane in lanes]), torch.stack([lane[1] for lane in lanes]),
        CostExpansion(*(torch.stack([lane[2][i] for lane in lanes]) for i in range(5))),
        torch.stack([lane[3] for lane in lanes]), torch.stack([lane[4] for lane in lanes]))
    reg = torch.from_numpy(10.0 ** rng.uniform(-6, -2, batch)) if batch else 1e-6
    ref = riccati_backward_associative(*data, reg)
    moved = [x.to(cuda_device) for x in data[:2]] + [CostExpansion(*(e.to(cuda_device) for e in data[2]))] + [
        x.to(cuda_device) for x in data[3:]]
    _build.reset_launches()
    out = riccati_backward_associative(*moved, reg.to(cuda_device) if batch else reg)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {smallchol.KERNEL: 2}
    _close_all(ref, out)


@pytest.mark.cuda
@pytest.mark.parametrize("linesearch", ["xla", "fused"])
def test_logged_fused_solve_matches_logged_vmap(cuda_device, linesearch):
    """The logged batched solve (float64): the fused backend's logs against "vmap"'s, and each lane against the
    single ``ilqr_solve_with_logs`` on the card; one K4 (and K7) launch per trip."""
    from quattro_tpu_torch.parallel import batched_ilqr_solve_with_logs
    from quattro_tpu_torch.solver import ilqr_solve_with_logs

    dyn, cost, fcost, x0s, u0s = batched_cartpole(cuda_device, batch=9)
    cfg = ILQRConfig(tol=1e-3, max_iter=8, linesearch=linesearch)
    _build.reset_launches()
    fused, logs = batched_ilqr_solve_with_logs(dyn, cost, fcost, x0s, u0s, cfg, riccati_backend="fused")
    torch.cuda.synchronize()
    trips = int(fused.iterations.max())
    expected = {fused_riccati.BATCHED_KERNEL: trips}
    if linesearch == "fused":
        expected[fused_rollout.BATCHED_KERNEL] = trips
    assert trips >= 2 and dict(_build.launches) == expected
    ref_sol, ref = batched_ilqr_solve_with_logs(dyn, cost, fcost, x0s, u0s, cfg, riccati_backend="vmap")
    assert torch.equal(logs.valid, ref.valid) and torch.equal(logs.found_update, ref.found_update)
    assert torch.equal(fused.iterations, ref_sol.iterations)
    for got, want in zip(logs, ref):
        np.testing.assert_allclose(got.cpu().double().numpy(), want.cpu().double().numpy(), rtol=1e-8,
                                   atol=1e-7 * max(float(want.abs().max()), 1.0))
    for lane in range(x0s.shape[0]):
        _, single = ilqr_solve_with_logs(dyn, cost, fcost, x0s[lane], u0s[lane], cfg)
        assert torch.equal(single.valid, logs.valid[lane])
        np.testing.assert_allclose(logs.x_seq[lane].cpu().numpy(), single.x_seq.cpu().numpy(), rtol=1e-8, atol=1e-9)


@pytest.mark.cuda
def test_collection_launches_k4_and_k7_once_per_trip(cuda_device):
    """A small float32 collection ("auto": the "fused" backend): one K4 and one K7 launch per trip, summed over
    the control steps (``stats.trips``), and every valid row kept on the card."""
    from quattro_tpu_torch.training import collect_gain_dataset

    t = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda_device)
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    cost = make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4))
    fcost = make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t([0.0] * 4))
    x0s = t(0.2 * np.random.default_rng(2).standard_normal((8, 4)))
    cfg = ILQRConfig(tol=1e-1, max_iter=6, linesearch="fused")
    _build.reset_launches()
    ds = collect_gain_dataset(dyn, cost, fcost, x0s, 12, 1, 4, cfg, compact_iters=6, device_resident=True)
    torch.cuda.synchronize()
    trips = ds.stats.trips
    assert trips >= 4
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: trips, fused_rollout.BATCHED_KERNEL: trips}
    assert ds.x_flat.is_cuda and len(ds) == ds.stats.rows_kept == ds.stats.rows_valid > 0
    assert torch.isfinite(ds.x_flat).all() and torch.isfinite(ds.kk_flat).all()


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(cuda_device):
    """Adam steps of the gain predictor on the card against the same steps on the CPU (float32, TF32 off,
    dropout 0): per-step losses within 1e-4 relative. (Parameters are not compared element by element: Adam
    moves a parameter whose gradient is near zero by about lr either way, so rounding noise in such a gradient
    flips its step.)"""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.training import TrainConfig
    from quattro_tpu_torch.training.train import _make_optimizer, _train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    batches = [tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((32, 13, 4), (32, 3, 5), (32, 9, 5))) for _ in range(4)]
    results = {}
    for device in (cuda_device, torch.device("cpu")):
        pred = GainPredictor.create(4, 5, prompt_len=3, target_len=9, d_model=32, nhead=4, num_decoder_layers=2,
                                    dim_feedforward=64, dropout=0.0, max_seq_len=32,
                                    generator=torch.Generator().manual_seed(3), device=device)
        module = pred.module.train()
        optimizer, scheduler = _make_optimizer(module, TrainConfig(lr_schedule="cosine", num_epochs=1), 4)
        results[device.type] = [float(_train_step(module, optimizer, scheduler, *(t.to(device) for t in b)))
                                 for b in batches]
    np.testing.assert_allclose(results["cuda"], results["cpu"], rtol=1e-4)


def cuda_mesh(device, shape, names):
    """A virtual mesh: the one card named once per shard."""
    from quattro_tpu_torch.parallel import make_mesh

    return make_mesh(shape, names, devices=[device] * int(np.prod(shape)))


def _moved(data, device):
    a, b, exp, v_x, v_xx = data
    return a.to(device), b.to(device), CostExpansion(*(e.to(device) for e in exp)), v_x.to(device), v_xx.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tree", "ring"])
def test_horizon_pass_on_card_matches_cpu(cuda_device, mode):
    """The horizon-partitioned pass on a virtual 4-shard mesh of the card against the same pass on a CPU mesh
    (float64, rtol 1e-9): one K8 and one K1 launch per shard, and the halo hops of ``halo_schedule_spec``."""
    from quattro_tpu_torch.parallel import collectives, make_mesh, sharded_riccati_backward
    from quattro_tpu_torch.parallel.horizon import halo_schedule_spec

    data = riccati_stages("cpu", seed=41, horizon=64)
    ref = sharded_riccati_backward(make_mesh((4,), ("horizon",), devices=["cpu"] * 4), *data, scan_mode=mode)
    _build.reset_launches()
    collectives.hops.reset()
    out = sharded_riccati_backward(cuda_mesh(cuda_device, (4,), ("horizon",)), *_moved(data, cuda_device),
                                   scan_mode=mode)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {smallchol.KERNEL: 4, fused_riccati.KERNEL: 4}
    spec = halo_schedule_spec(12, torch.float64, 4, mode)
    assert collectives.hops.rounds == spec["rounds"]
    assert collectives.hops.bytes_per_hop == [spec["payload_bytes_per_hop"]] * spec["rounds"]
    assert all(t.is_cuda for t in out)
    _close_all(ref, out)


@pytest.mark.cuda
def test_podscale_on_card_matches_cpu(cuda_device):
    """The pod-scale pass on a virtual (2, 2) mesh of the card against the CPU mesh (float64, rtol 1e-9): two K8
    launches per shard (stage elements, gains)."""
    from quattro_tpu_torch.parallel import make_mesh, podscale_riccati_backward

    lanes = [riccati_stages("cpu", seed=50 + i, horizon=16) for i in range(4)]
    data = (torch.stack([lane[0] for lane in lanes]), torch.stack([lane[1] for lane in lanes]),
            CostExpansion(*(torch.stack([lane[2][i] for lane in lanes]) for i in range(5))),
            torch.stack([lane[3] for lane in lanes]), torch.stack([lane[4] for lane in lanes]))
    ref = podscale_riccati_backward(make_mesh((2, 2), devices=["cpu"] * 4), *data)
    _build.reset_launches()
    out = podscale_riccati_backward(cuda_mesh(cuda_device, (2, 2), ("traj", "horizon")), *_moved(data, cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {smallchol.KERNEL: 8}
    _close_all(ref, out)


@pytest.mark.cuda
def test_sharded_solve_on_card_launches_k4_and_k7_per_shard_trip(cuda_device):
    """``sharded_ilqr_solve`` on a virtual (2, 1) mesh, float32, linesearch="fused": each shard of 8 lanes takes
    K4 and K7 once per trip of its own; every lane equals ``batched_ilqr_solve``'s on the card (iterations and
    flags, cost within 1e-4 relative); float64 against the CPU run (cost rtol 1e-9, u atol 1e-8)."""
    from quattro_tpu_torch.parallel import make_mesh, sharded_ilqr_solve

    def cartpole(device, dtype):
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        rng = np.random.default_rng(2)
        return (make_discrete(CartPoleField(), 0.01, "rk4"),
                make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4)),
                make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t([0.0] * 4)),
                t(0.2 * rng.standard_normal((16, 4))), t(np.zeros((16, 10, 1))))

    cfg = ILQRConfig(tol=1e-3, max_iter=6, linesearch="fused")
    args = cartpole(cuda_device, torch.float32)
    _build.reset_launches()
    sharded = sharded_ilqr_solve(*args, cuda_mesh(cuda_device, (2, 1), ("traj", "horizon")), cfg)
    torch.cuda.synchronize()
    trips = int(sharded.iterations[:8].max()) + int(sharded.iterations[8:].max())
    assert dict(_build.launches) == {fused_riccati.BATCHED_KERNEL: trips, fused_rollout.BATCHED_KERNEL: trips}
    plain = batched_ilqr_solve(*args, cfg)
    assert torch.equal(sharded.iterations, plain.iterations) and torch.equal(sharded.converged, plain.converged)
    assert float(((sharded.cost - plain.cost).abs() / plain.cost.abs()).max()) <= 1e-4
    ref = sharded_ilqr_solve(*cartpole("cpu", torch.float64), make_mesh((2, 1), devices=["cpu"] * 2), cfg)
    got = sharded_ilqr_solve(*cartpole(cuda_device, torch.float64), cuda_mesh(cuda_device, (2, 1), ("traj", "horizon")),
                             cfg)
    assert torch.equal(got.iterations.cpu(), ref.iterations) and torch.equal(got.converged.cpu(), ref.converged)
    np.testing.assert_allclose(got.cost.cpu().numpy(), ref.cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(got.u_seq.cpu().numpy(), ref.u_seq.numpy(), rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_halo_check_on_card(cuda_device):
    """``verify_halo_exchange`` on a virtual 4-shard mesh of the card: 0.0 clean, 1.0 where one bit flipped."""
    from quattro_tpu_torch.parallel import collectives
    from quattro_tpu_torch.utils import verify_halo_exchange

    mesh = cuda_mesh(cuda_device, (4,), ("horizon",))
    comm = collectives.AxisComm(mesh, "horizon", mesh.coords(("horizon",)))
    data = riccati_stages(cuda_device, seed=60, horizon=4)
    sent = {c: (data[0][c[0]], data[3]) for c in comm.local}
    perm = [(i, (i - 1) % 4) for i in range(4)]
    received = comm.ppermute(sent, perm)
    assert all(float(v) == 0.0 for v in verify_halo_exchange(sent, received, comm, perm).values())
    bad = received[(3,)][0].clone()
    bad.view(torch.int64)[2, 2] ^= 1
    received[(3,)] = (bad, received[(3,)][1])
    flags = verify_halo_exchange(sent, received, comm, perm)
    assert {c[0]: float(v) for c, v in flags.items()} == {0: 0.0, 1: 0.0, 2: 0.0, 3: 1.0}


@pytest.mark.cuda
def test_data_parallel_training_on_card_matches_unsharded(cuda_device):
    """5 Adam steps with ``mesh=`` over a virtual (4,) mesh of the card against ``mesh=None`` on the card (float32,
    TF32 off, dropout 0.1 with the masks shared): per-step losses within 1e-5 relative."""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.training import GainDataset, TrainConfig, train_gain_predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    data = GainDataset(rng.standard_normal((64, 13, 4)).astype(np.float32),
                       rng.standard_normal((64, 12, 5)).astype(np.float32))
    config = TrainConfig(num_epochs=5, batch_size=64, learning_rate=3e-3)
    losses = []
    for mesh in (None, cuda_mesh(cuda_device, (4,), ("data",))):
        pred = GainPredictor.create(4, 5, prompt_len=3, target_len=9, d_model=32, nhead=4, num_decoder_layers=2,
                                    dim_feedforward=64, dropout=0.1, max_seq_len=32,
                                    generator=torch.Generator().manual_seed(3), device=cuda_device)
        losses.append(train_gain_predictor(pred, data, None, config, mesh=mesh).train_loss_history)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
