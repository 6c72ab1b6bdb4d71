"""The plain reference agrees with itself in float64 at a tiny size."""

import json

import pytest
import torch

from bench_cuda.reference import ilqr, judge
from bench_cuda.tests.conftest import ROOT

CART = json.loads((ROOT / "bench_cuda" / "configs" / "cartpole-h30.json").read_text())
QUAD = json.loads((ROOT / "bench_cuda" / "configs" / "quadrotor-h50.json").read_text())


def small(cfg, horizon):
    return {**cfg, "horizon": horizon}


def test_jacobians_match_central_differences():
    prob = ilqr.Problem(QUAD)
    gen = torch.Generator().manual_seed(0)
    xs = 0.1 * torch.randn(1, 3, 12, generator=gen, dtype=torch.float64)
    us = 2.4525 + 0.1 * torch.randn(1, 2, 4, generator=gen, dtype=torch.float64)
    a, b = prob.jacobians(xs, us)
    h = 1e-6
    for j in range(12):
        e = torch.zeros(12, dtype=torch.float64)
        e[j] = h
        fd = (prob.step(xs[0, 1] + e, us[0, 1]) - prob.step(xs[0, 1] - e, us[0, 1])) / (2 * h)
        torch.testing.assert_close(a[0, 1, :, j], fd, rtol=1e-7, atol=1e-9)


def test_cost_expansion_matches_autograd():
    prob = ilqr.Problem(QUAD)
    xs = torch.full((1, 2, 12), 0.1, dtype=torch.float64)
    us = torch.tensor([[[0.05, -0.02, 2.0, 0.3]]], dtype=torch.float64)
    l_x, l_u, l_xx, l_uu = prob.cost_expansion(xs, us)
    x, u = xs[0, 0], us[0, 0]
    torch.testing.assert_close(l_x[0, 0], torch.func.grad(prob.running_cost, 0)(x, u))
    torch.testing.assert_close(l_u[0, 0], torch.func.grad(prob.running_cost, 1)(x, u))
    torch.testing.assert_close(l_xx, torch.func.hessian(prob.running_cost, 0)(x, u))
    torch.testing.assert_close(l_uu[0, 0], torch.func.hessian(prob.running_cost, 1)(x, u))


@pytest.mark.parametrize("cfg", [small(CART, 8), small(QUAD, 6)], ids=["cartpole", "quadrotor"])
def test_lanes_in_lockstep_equal_lanes_alone(cfg):
    prob = ilqr.Problem(cfg)
    gen = torch.Generator().manual_seed(1)
    x0 = 0.1 * torch.randn(3, cfg["state_dim"], generator=gen, dtype=torch.float64)
    u0 = torch.tensor(cfg["hover_control"], dtype=torch.float64).expand(3, cfg["horizon"], -1)
    together = ilqr.solve(prob, x0, u0, 4, cfg["tol"], follow_ties=False)
    for lane in range(3):
        alone = ilqr.solve(prob, x0[lane:lane + 1], u0[lane:lane + 1], 4, cfg["tol"], follow_ties=False)
        torch.testing.assert_close(together[lane][0].u_seq, alone[0][0].u_seq, rtol=1e-12, atol=1e-12)
        assert together[lane][0].iterations == alone[0][0].iterations


def test_solve_descends_and_the_plan_is_its_rollout():
    cfg = small(QUAD, 10)
    prob = ilqr.Problem(cfg)
    x0 = torch.zeros(1, 12, dtype=torch.float64)
    x0[0, 2], x0[0, 6] = 0.45, 0.1
    u0 = torch.tensor(cfg["hover_control"], dtype=torch.float64).expand(1, 10, -1)
    leaf = ilqr.solve(prob, x0, u0, 6, 0.0, follow_ties=False)[0][0]
    assert leaf.cost < float(prob.trajectory_cost(prob.rollout(x0, u0), u0)[0])
    torch.testing.assert_close(leaf.x_seq, prob.rollout(x0[0], leaf.u_seq), rtol=0, atol=1e-14)
    numbers, iterations = judge.gaps(cfg, x0, u0, leaf.x_seq[None], leaf.u_seq[None], 6, 0.0)
    assert numbers == {"u_gap": 0.0, "plan_gap": 0.0} and iterations == [leaf.iterations]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-12, 1.0 + 2.0**-12, -3.0], dtype=torch.float32)
    torch.testing.assert_close(ilqr.round_tf32(x), torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -3.0]),
                               rtol=0, atol=0)
