"""Receding-horizon MPC controllers over the iLQR solver.

Counterpart of ``quattro_tpu/control/mpc.py``. ``MPCController.step`` is
``(x_current, mpc_state) -> (u_applied, x_plan, mpc_state')``; the carried
``MPCState`` holds the warm-started control sequence, shifted and held at
every step.

Modes:
- ``ilqr``    pure iLQR
- ``hybrid``  iLQR with transformer gain prediction
- ``lqr``     infinite-horizon LQR only
- ``blend``   error-norm-weighted mix of hybrid/iLQR and LQR with the
              reference's 0.05/0.95 cutoffs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from quattro_tpu_torch.control.switcher import blending_weight
from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.solver.costs import make_quadratic_cost, make_quadratic_final_cost
from quattro_tpu_torch.solver.ilqr import (
    GainPredictFn,
    ILQRConfig,
    hybrid_ilqr_solve,
    ilqr_solve,
    ilqr_solve_fused,
)
from quattro_tpu_torch.solver.lqr import lqr_gain
from quattro_tpu_torch.systems.cartpole import CartPoleField, CartPoleParams, cartpole_linearized
from quattro_tpu_torch.systems.integrators import make_discrete
from quattro_tpu_torch.systems.quadrotor import QuadrotorField, QuadrotorParams
from quattro_tpu_torch.utils.timing import span


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
    lqr_matrices: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    blend_epsilon: Tuple[float, float] = (0.5, 1.5),
    exact_fallback: bool = True,
    solver: str = "while",
) -> MPCController:
    """Assemble a control step for the requested mode on ``x_ref``'s device.

    ``exact_fallback`` (default True, matching the factories): hybrid solves
    are convergence-certified -- a would-be-terminating iteration is redone
    with the exact full-horizon backward pass (see ``hybrid_ilqr_solve``).
    Pass False for the raw hybrid semantics, or in ``blend`` mode when
    per-step latency matters more: near the setpoint blend discards the hybrid
    solution for pure LQR, so the certification's extra exact backward pass
    there buys nothing.

    ``solver`` selects the pure-iLQR solve implementation:

    - ``"while"`` (default): ``ilqr_solve`` -- a loop with early exit; per-step
      latency varies with how many iterations the warm start needs.
    - ``"megakernel"``: ``ilqr_solve_fused`` -- the whole solve (linearize,
      Riccati, line search, bookkeeping) as ONE kernel launch, which leaves
      its trip loop once the solve is done. ``config.max_iter`` is the
      iteration budget and bounds the step latency for hard real-time loops
      (a warm-started receding-horizon step typically converges in <= 6);
      below that bound the latency follows the iterations the step needs and
      is not constant. Pure solves only (a ``predict_fn`` needs the
      hybrid path); ``adaptive_reg`` is rejected by the kernel. On CUDA the
      dynamics and costs must be ones the kernel carries (see
      ``ops/fused_solve.py``).
    """
    if mode in ("hybrid", "blend") and predict_fn is not None and prompt_len is None:
        raise ValueError("prompt_len is required when a predictor is supplied")
    if solver not in ("while", "megakernel"):
        raise ValueError(f"Unknown solver: {solver!r} (expected 'while' or 'megakernel')")
    if mode not in ("ilqr", "hybrid", "lqr", "blend"):
        raise ValueError(f"Unknown MPC mode: {mode!r}")

    use_predictor = predict_fn is not None
    if solver == "megakernel" and use_predictor:
        raise ValueError(
            "solver='megakernel' fuses the pure iLQR solve; hybrid/predictor "
            "controllers need solver='while'"
        )
    if solver == "megakernel" and config.adaptive_reg:
        # ilqr_solve_fused rejects this too, but only at the first step --
        # fail at construction like the other checks here.
        raise ValueError(
            "solver='megakernel' runs every trip with the one reg it is given (the kernel "
            "carries no mu-schedule); adaptive_reg needs solver='while'"
        )

    device = x_ref.device

    if mode in ("lqr", "blend"):
        if lqr_matrices is None:
            raise ValueError(f"mode={mode!r} needs lqr_matrices=(A_d, B_d, Q_lqr, R_lqr)")
        k_lqr, _ = lqr_gain(*lqr_matrices)

        def lqr_control(x):
            # Double negation preserved from the reference: its control step
            # returns minus its LQR control, which itself is -K dx, so the
            # applied control is +K dx here, and the simulation harness
            # negates once more into the actuator.
            return k_lqr @ (x - x_ref)

    def solve_from(x, u_warm):
        if x.device != device:
            raise ValueError(f"state on {x.device}, controller on {device}")
        if use_predictor:
            return hybrid_ilqr_solve(
                dynamics, running_cost, final_cost, predict_fn, prompt_len, x, u_warm,
                x_ref, config, state_offset, exact_fallback=exact_fallback,
            )
        if solver == "megakernel":
            return ilqr_solve_fused(dynamics, running_cost, final_cost, x, u_warm, config)
        return ilqr_solve(dynamics, running_cost, final_cost, x, u_warm, config)

    if mode == "lqr":

        def step(x: torch.Tensor, state: MPCState):
            return lqr_control(x), x.new_zeros((horizon + 1, x.shape[0])), state

    elif mode in ("ilqr", "hybrid"):

        def step(x: torch.Tensor, state: MPCState):
            with span("mpc.step"):
                sol = solve_from(x, state.u_warm)
                return sol.u_seq[0], sol.x_seq, MPCState(shift_warm_start(sol.u_seq))

    else:
        eps_low, eps_high = blend_epsilon

        def step(x: torch.Tensor, state: MPCState):
            with span("mpc.step"):
                w = blending_weight(x - x_ref, eps_low, eps_high)
                sol = solve_from(x, state.u_warm)
                u_primary = sol.u_seq[0]
                u_lqr = lqr_control(x)
                # Reference cutoffs. The solve still runs in the w <= 0.05 branch
                # (it keeps the warm start moving), but its control is discarded
                # exactly as the reference discards iLQR there. No host read.
                u = torch.where(
                    w <= 0.05,
                    u_lqr,
                    torch.where(w >= 0.95, u_primary, w * u_primary + (1.0 - w) * u_lqr),
                )
                return u, sol.x_seq, MPCState(shift_warm_start(sol.u_seq))

    return MPCController(horizon=horizon, control_dim=control_dim, device=device, step=step)


def _factory_linesearch(dev: torch.device) -> str:
    """The factories' plants are ones K2 carries: on CUDA the line search is K2."""
    return "fused" if dev.type == "cuda" else "xla"


def make_cartpole_mpc(
    horizon: int = 30,
    dt: float = 0.01,
    integration: str = "rk4",
    mode: str = "ilqr",
    predict_fn: Optional[GainPredictFn] = None,
    prompt_len: Optional[int] = None,
    tol: float = 1e-1,
    exact_fallback: bool = True,
    riccati: str = "auto",
    parallel_riccati: Optional[bool] = None,
    solver: str = "while",
    max_iter: int = 100,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> MPCController:
    """Cart-pole MPC with the reference's cost tables. Runs on CUDA unless ``device="cpu"``.

    The LQR fallback uses the simplified analytic linearization discretized
    as ``A_d = I + dt A, B_d = dt B``. As in ``make_quadrotor_mpc``, on CUDA
    the line search is ``"fused"`` (K2 carries this plant) and on the CPU it
    is ``"xla"``.
    """
    dev = resolve_device(device)
    params = CartPoleParams()
    dyn = make_discrete(CartPoleField(params), dt, integration)

    def vec(values):
        return torch.tensor(values, dtype=dtype, device=dev)

    x_ref = vec([0.0] * 4)
    cost = make_quadratic_cost(vec([5.0, 0.1, 10.0, 0.1]), vec([0.001]), x_ref)
    fcost = make_quadratic_final_cost(vec([50.0, 6.0, 100.0, 0.1]), x_ref)

    lqr_matrices = None
    if mode in ("lqr", "blend"):
        a_c, b_c = cartpole_linearized(params, device=dev, dtype=dtype)
        a_d = torch.eye(4, dtype=dtype, device=dev) + dt * a_c
        b_d = dt * b_c
        lqr_matrices = (a_d, b_d, torch.diag(vec([1.0, 0.1, 10.0, 0.1])), torch.diag(vec([0.001])))

    config = ILQRConfig(
        tol=tol, max_iter=max_iter, riccati=riccati, parallel_riccati=parallel_riccati,
        linesearch=_factory_linesearch(dev),
    )
    return build_mpc(
        dyn, cost, fcost, x_ref, horizon, 1, config, mode=mode, predict_fn=predict_fn,
        prompt_len=prompt_len, lqr_matrices=lqr_matrices, exact_fallback=exact_fallback, solver=solver,
    )


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
        linesearch=_factory_linesearch(dev),
    )
    return build_mpc(
        dyn, cost, fcost, x_ref, horizon, 4, config, mode=mode, predict_fn=predict_fn,
        prompt_len=prompt_len, state_offset=x_ref.clone(), exact_fallback=exact_fallback, solver=solver,
    )
