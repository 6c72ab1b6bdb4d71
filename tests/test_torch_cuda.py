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

from quattro_tpu_torch.ops import _build, fused_riccati, fused_rollout
from quattro_tpu_torch.solver import CostExpansion, ILQRConfig, ilqr_solve, make_quadratic_cost, make_quadratic_final_cost
from quattro_tpu_torch.systems import QuadrotorField, make_discrete, quadrotor_dynamics

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


def rollout_inputs(device, seed=3, horizon=100):
    rng = np.random.default_rng(seed)
    values = (
        0.1 * rng.standard_normal(12),
        0.1 * rng.standard_normal((horizon + 1, 12)),
        2.4525 + 0.1 * rng.standard_normal((horizon, 4)),
        0.05 * rng.standard_normal((horizon, 4)),
        0.05 * rng.standard_normal((horizon, 4, 12)),
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
