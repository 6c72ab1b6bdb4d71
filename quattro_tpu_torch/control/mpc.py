"""Receding-horizon MPC controllers over the iLQR solver.

Counterpart of ``quattro_tpu/control/mpc.py``. ``MPCController.step`` is
``(x_current, mpc_state) -> (u_applied, x_plan, mpc_state')``; the carried
``MPCState`` holds the warm-started control sequence, shifted and held at
every step.

Modes ``"ilqr"`` (pure iLQR) and ``"hybrid"`` (iLQR with transformer gain
prediction) are ported; ``"lqr"``, ``"blend"``, ``solver="megakernel"`` and
the cart-pole factory raise ``NotImplementedError`` until a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.solver.costs import make_quadratic_cost, make_quadratic_final_cost
from quattro_tpu_torch.solver.ilqr import (
    MEGAKERNEL_TODO,
    GainPredictFn,
    ILQRConfig,
    hybrid_ilqr_solve,
    ilqr_solve,
)
from quattro_tpu_torch.systems.integrators import make_discrete
from quattro_tpu_torch.systems.quadrotor import QuadrotorField, QuadrotorParams

LQR_BLEND_TODO = (
    "ROADMAP.md, Queue 1 item 11: modes 'lqr' and 'blend' need solver/lqr.py and "
    "control/switcher.py, which are not ported yet"
)
CARTPOLE_TODO = "ROADMAP.md, Queue 1 item 2: the cart-pole plant is not ported yet"


class MPCState(NamedTuple):
    """Carried controller state: the warm-started control sequence."""

    u_warm: torch.Tensor  # (H, m)


def shift_warm_start(u_seq: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift-and-hold: ``u <- [u[1:], u[-1]]``."""
    return torch.cat([u_seq[1:], u_seq[-1:]])


@dataclasses.dataclass(frozen=True)
class MPCController:
    """A receding-horizon controller bound to one device."""

    horizon: int
    control_dim: int
    device: torch.device
    step: Callable[[torch.Tensor, MPCState], Tuple[torch.Tensor, torch.Tensor, MPCState]]

    def init_state(self, dtype=torch.float32) -> MPCState:
        return MPCState(u_warm=torch.zeros((self.horizon, self.control_dim), dtype=dtype, device=self.device))


def build_mpc(
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    running_cost: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    final_cost: Callable[[torch.Tensor], torch.Tensor],
    x_ref: torch.Tensor,
    horizon: int,
    control_dim: int,
    config: ILQRConfig,
    mode: str = "ilqr",
    predict_fn: Optional[GainPredictFn] = None,
    prompt_len: Optional[int] = None,
    state_offset: Optional[torch.Tensor] = None,
    lqr_matrices=None,
    blend_epsilon: Tuple[float, float] = (0.5, 1.5),
    exact_fallback: bool = True,
    solver: str = "while",
) -> MPCController:
    """Assemble a control step for the requested mode on ``x_ref``'s device.

    ``exact_fallback`` (default True): hybrid solves are convergence-certified
    (see ``hybrid_ilqr_solve``).
    """
    if mode in ("hybrid", "blend") and predict_fn is not None and prompt_len is None:
        raise ValueError("prompt_len is required when a predictor is supplied")
    if solver not in ("while", "megakernel"):
        raise ValueError(f"Unknown solver: {solver!r} (expected 'while' or 'megakernel')")
    if mode not in ("ilqr", "hybrid", "lqr", "blend"):
        raise ValueError(f"Unknown MPC mode: {mode!r}")
    if mode in ("lqr", "blend"):
        raise NotImplementedError(LQR_BLEND_TODO)
    if solver == "megakernel":
        raise NotImplementedError(MEGAKERNEL_TODO)

    device = x_ref.device

    def step(x: torch.Tensor, state: MPCState):
        if x.device != device:
            raise ValueError(f"state on {x.device}, controller on {device}")
        if predict_fn is not None:
            sol = hybrid_ilqr_solve(
                dynamics, running_cost, final_cost, predict_fn, prompt_len, x, state.u_warm,
                x_ref, config, state_offset, exact_fallback=exact_fallback,
            )
        else:
            sol = ilqr_solve(dynamics, running_cost, final_cost, x, state.u_warm, config)
        return sol.u_seq[0], sol.x_seq, MPCState(shift_warm_start(sol.u_seq))

    return MPCController(horizon=horizon, control_dim=control_dim, device=device, step=step)


def make_cartpole_mpc(*args, **kwargs) -> MPCController:
    raise NotImplementedError(CARTPOLE_TODO)


def make_quadrotor_mpc(
    horizon: int = 50,
    dt: float = 0.01,
    integration: str = "rk4",
    mode: str = "ilqr",
    predict_fn: Optional[GainPredictFn] = None,
    prompt_len: Optional[int] = None,
    tol: float = 1e-3,
    riccati: str = "auto",
    parallel_riccati: Optional[bool] = None,
    quad_params: Optional[QuadrotorParams] = None,
    exact_fallback: bool = True,
    solver: str = "while",
    max_iter: int = 100,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> MPCController:
    """Quadrotor hover MPC with the reference cost tables, softplus barrier and
    hover state offset z=0.5. Runs on CUDA unless ``device="cpu"``.

    On CUDA the line search is ``"fused"``: kernel K2, which carries this
    plant, rolls the six step sizes out in one launch, where the PyTorch form
    issues a few hundred small launches per time step (about 200 ms against
    2 ms at H=50 on an H100, PERF.md). On the CPU it is ``"xla"``, as in the
    JAX factory. Both give the same solve.
    """
    dev = resolve_device(device)
    params = quad_params if quad_params is not None else QuadrotorParams()
    dyn = make_discrete(QuadrotorField(params), dt, integration)

    def vec(values):
        return torch.tensor(values, dtype=dtype, device=dev)

    x_ref = vec([0.0, 0.0, 0.5] + [0.0] * 9)
    q = vec([10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0])
    qf = vec([100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0])
    cost = make_quadratic_cost(q, vec([0.01] * 4), x_ref, barrier_alpha=1000.0, barrier_beta=10.0)
    fcost = make_quadratic_final_cost(qf, x_ref)
    config = ILQRConfig(
        tol=tol, max_iter=max_iter, riccati=riccati, parallel_riccati=parallel_riccati,
        linesearch="fused" if dev.type == "cuda" else "xla",
    )
    return build_mpc(
        dyn, cost, fcost, x_ref, horizon, 4, config, mode=mode, predict_fn=predict_fn,
        prompt_len=prompt_len, state_offset=x_ref.clone(), exact_fallback=exact_fallback, solver=solver,
    )
