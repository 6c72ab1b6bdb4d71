"""The whole iLQR solve in one launch (kernel K3) and its plain form.

Counterpart of ``quattro_tpu/ops/fused_solve.py::fused_ilqr_solve_kernel``:
up to ``max_iter`` trips of linearize + quadratize, backward Riccati (the
fused step law of ``ops/fused_riccati.py``), all-alpha rollouts with the
running cost summed step by step and the final cost added last, first-accept
select and the convergence bookkeeping, which sets ``done``. The loop leaves
after the trip that sets ``done``. The JAX kernel runs every trip under a
``done`` mask, and a trip after convergence changes nothing there, so the
outputs are the same bit for bit and only the time differs: ``max_iter``
bounds a solve's latency, and below it the trips follow the data. The gains
returned are those of the last trip. ``fused_ilqr_solve_from_x0`` is the
same solve given the start state: the launch rolls ``u_init`` out from
``x0`` and costs it before its first trip, where ``fused_ilqr_solve_kernel``
(the JAX function's counterpart) takes that rollout and its cost from the
caller.

The TPU kernel traces the user's dynamics and costs into its body. A CUDA
kernel cannot, so ``csrc/fused_solve.cu`` carries the in-repo plants
(``csrc/plants.cuh``) and the quadratic + softplus^2-barrier cost family
(``csrc/costs.cuh``) with their derivatives as device functions, and the
wrapper reads the plant descriptor of the discrete map and the tables of the
cost objects (``solver/costs.py``). On CUDA tensors a plant or a cost the
kernel does not know raises ``ValueError``; CPU tensors take the plain form
with the callables themselves. There is no route from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops import _build, contract
from quattro_tpu_torch.ops.fused_riccati import riccati_backward_fused_single_plain
from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts_plain
from quattro_tpu_torch.solver.derivatives import linearize_dynamics, quadratize_cost, quadratize_final_cost
from quattro_tpu_torch.solver.rollout import simulate

KERNEL = "fused_solve"
MAX_ALPHAS = 64

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]
SolveOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _cost_in_time_order(step_cost, last_cost, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Σ_t L(x_t, u_t) + Lf(x_H) as K3 sums it: the running costs added one step at a time from t = 0, the final
    cost last. ``xs`` (..., H+1, n) and ``us`` (..., H, m); ``step_cost`` and ``last_cost`` take the leading axes."""
    run = torch.zeros(xs.shape[:-2], dtype=xs.dtype, device=xs.device)
    for t in range(us.shape[-2]):
        run = run + step_cost(xs[..., t, :], us[..., t, :])
    return run + last_cost(xs[..., -1, :])


def fused_ilqr_solve_kernel_plain(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x_init_seq: torch.Tensor,
    u_init: torch.Tensor,
    cost_init: torch.Tensor,
    max_iter: int,
    tol: float,
    reg: float,
    alphas: Sequence[float],
) -> SolveOutputs:
    """Plain PyTorch form of K3: the same trip loop, which leaves once ``done`` holds (one host read a trip)."""
    horizon, m = u_init.shape
    n = x_init_seq.shape[-1]
    dtype, device = x_init_seq.dtype, x_init_seq.device
    alphas_t = torch.as_tensor(alphas, dtype=dtype, device=device)
    step_cost, last_cost = vmap(cost), vmap(final_cost)

    xs, us = x_init_seq, u_init
    k_out = u_init.new_zeros((horizon, m))
    big_k_out = u_init.new_zeros((horizon, m, n))
    cur = torch.as_tensor(cost_init, dtype=dtype, device=device).reshape(())
    done = torch.zeros((), dtype=torch.bool, device=device)
    iters = torch.zeros((), dtype=dtype, device=device)

    for _ in range(max_iter):
        active = ~done
        a_seq, b_seq = linearize_dynamics(dynamics, xs, us)
        cost_exp = quadratize_cost(cost, xs, us)
        final_exp = quadratize_final_cost(final_cost, xs[-1])
        k_seq, big_k_seq, _, _ = riccati_backward_fused_single_plain(
            a_seq, b_seq, cost_exp, final_exp.v_x, final_exp.v_xx, reg
        )
        cand_x, cand_u = fused_feedback_rollouts_plain(dynamics, xs[0], xs, us, k_seq, big_k_seq, alphas_t)
        # The order decides near-tie accepts, so the kernel sums the same way.
        total = _cost_in_time_order(step_cost, last_cost, cand_x, cand_u)

        accepted = total <= cur
        found = accepted.any()
        first = torch.argmax(accepted.to(torch.int8))  # first accepted (largest) alpha
        update = active & found
        xs = torch.where(update, cand_x[first], xs)
        us = torch.where(update, cand_u[first], us)
        k_out = torch.where(active, k_seq, k_out)
        big_k_out = torch.where(active, big_k_seq, big_k_out)
        cost_next = torch.where(update, total[first], cur)
        small = (cur - cost_next).abs() < tol
        done = torch.where(active, ~found | small, done)
        iters = iters + active.to(dtype)
        cur = cost_next
        if bool(done):
            break

    stats = torch.stack([cur, iters, done.to(dtype)]).reshape(1, 3)
    return xs, us, k_out, big_k_out, stats


def _prepare(dynamics, cost, final_cost, x_init_seq, u_init, cost_init, max_iter, tol, reg, alphas):
    """K3's checked arguments: ``(fn, args, outputs, keep)``. ``fn(*args, stream)`` is one launch
    (``_build.launch`` adds the stream); ``keep`` holds the tensors that the pointers in ``args`` name.

    ``cost_init`` None: ``x_init_seq`` is the start state x0 (n,), and the launch rolls ``u_init`` out
    from it and costs it before its first trip."""
    horizon, m = u_init.shape
    n = x_init_seq.shape[-1]
    n_alpha = len(alphas)
    dtype, device = x_init_seq.dtype, x_init_seq.device
    plant_id, params, rk4, dt = contract.device_plant(dynamics, KERNEL, n, m)
    if n > contract.MAX_N or m > contract.MAX_M or not 1 <= n_alpha <= MAX_ALPHAS or max_iter < 0:
        raise ValueError(
            f"{KERNEL} takes n <= {contract.MAX_N}, m <= {contract.MAX_M}, 1..{MAX_ALPHAS} alphas and max_iter >= 0; "
            f"got n={n}, m={m}, {n_alpha} alphas, max_iter={max_iter}"
        )
    alphas_t = torch.tensor([float(a) for a in alphas], dtype=dtype, device=device)
    # The entry point's ten inputs: x_init and cost_init with x0 (the last) null, or x0 with the two null.
    x_init, x0 = (None, x_init_seq) if cost_init is None else (x_init_seq, None)
    if cost_init is not None:
        cost_init = torch.as_tensor(cost_init, dtype=dtype, device=device).reshape(1)
    x_init, u_init, cost_init, alphas_t, x0 = contract.checked(
        KERNEL, [x_init, u_init, cost_init, alphas_t, x0], [(horizon + 1, n), (horizon, m), (1,), (n_alpha,), (n,)],
        dtype, device)
    tables, barrier_alpha, barrier_beta = contract.cost_tables(KERNEL, cost, final_cost, n, m, x_init_seq)
    inputs = [x_init, u_init, cost_init, *tables, alphas_t, x0]
    outputs = [
        x_init_seq.new_empty((horizon + 1, n)),
        x_init_seq.new_empty((horizon, m)),
        x_init_seq.new_empty((horizon, m)),
        x_init_seq.new_empty((horizon, m, n)),
        x_init_seq.new_empty((1, 3)),
    ]

    count = _build.bind(KERNEL, "qt_fused_solve_workspace", ctypes.c_longlong, [ctypes.c_int] * 3)
    workspace_elems = count(plant_id, horizon, n_alpha)
    if workspace_elems < 0:
        raise ValueError(f"{KERNEL}: no workspace size for plant {plant_id}, H={horizon}, {n_alpha} alphas")
    workspace = x_init_seq.new_empty((max(workspace_elems, 1),))

    fn = _build.bind(KERNEL, "qt_fused_solve", ctypes.c_int,
                     [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_double)] + [ctypes.c_double] * 5
                     + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    in_ptrs = (ctypes.c_void_p * len(inputs))(*[None if t is None else t.data_ptr() for t in inputs])
    out_ptrs = (ctypes.c_void_p * len(outputs))(*[t.data_ptr() for t in outputs])
    args = (contract.DTYPES[dtype], plant_id, horizon, n_alpha, int(max_iter), rk4, params, dt, float(reg), float(tol),
            barrier_alpha, barrier_beta, in_ptrs, out_ptrs, workspace.data_ptr(), workspace_elems)
    return fn, args, tuple(outputs), (inputs, workspace)


def _launch(*problem) -> SolveOutputs:
    fn, args, outputs, _ = _prepare(*problem)
    _build.launch(KERNEL, fn, outputs[0].device, *args)
    return outputs


def fused_ilqr_solve_kernel(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x_init_seq: torch.Tensor,  # (H+1, n) initial rollout of u_init
    u_init: torch.Tensor,  # (H, m)
    cost_init: torch.Tensor,  # scalar
    max_iter: int,
    tol: float,
    reg: float,
    alphas: Sequence[float],
) -> SolveOutputs:
    """Run the whole solve, up to ``max_iter`` trips: K3 once on CUDA tensors, the plain form on CPU tensors.

    Returns ``(x_seq (H+1, n), u_seq (H, m), k_seq (H, m), big_k_seq (H, m, n),
    stats (1, 3) = [cost, iterations, converged])``. The JAX function's
    ``interpret`` and ``lin_block`` arguments are not carried over: the first
    selects Pallas's interpreter, the second blocks the linearize phase to
    fit the TPU's scoped VMEM, and neither has a meaning on this card.

    On CUDA the dynamics must be ``make_discrete`` of a plant the kernel knows
    (``QuadrotorField``, ``CartPoleField``) and the costs those of
    ``make_quadratic_cost`` / ``make_quadratic_final_cost``, with tables of
    the trajectory's dtype on its device; anything else raises ``ValueError``.
    """
    return contract.on_device(KERNEL, x_init_seq, _launch, fused_ilqr_solve_kernel_plain,
                     dynamics, cost, final_cost, x_init_seq, u_init, cost_init, max_iter, tol, reg, alphas)


def fused_ilqr_solve_from_x0_plain(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    u_init: torch.Tensor,
    max_iter: int,
    tol: float,
    reg: float,
    alphas: Sequence[float],
) -> SolveOutputs:
    """Plain PyTorch form of K3 given x0: ``simulate``, the cost in K3's time order, then the plain solve."""
    x_init_seq = simulate(dynamics, x0, u_init)
    cost_init = _cost_in_time_order(cost, final_cost, x_init_seq, u_init)
    return fused_ilqr_solve_kernel_plain(
        dynamics, cost, final_cost, x_init_seq, u_init, cost_init, max_iter, tol, reg, alphas
    )


def fused_ilqr_solve_from_x0(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,  # (n,) start state
    u_init: torch.Tensor,  # (H, m)
    max_iter: int,
    tol: float,
    reg: float,
    alphas: Sequence[float],
) -> SolveOutputs:
    """``fused_ilqr_solve_kernel`` from the start state: K3 once on CUDA tensors, the plain form on CPU tensors.

    Before its first trip the launch rolls ``u_init`` out from ``x0`` with K2's step, so the trajectory
    is K2's at zero gains and step size 1, and sums its cost in time order with the final cost last,
    as it sums each line-search candidate's. Outputs and refusals as ``fused_ilqr_solve_kernel``'s.
    """
    solve = (max_iter, tol, reg, alphas)
    return contract.on_device(KERNEL, x0, lambda: _launch(dynamics, cost, final_cost, x0, u_init, None, *solve),
                     lambda: fused_ilqr_solve_from_x0_plain(dynamics, cost, final_cost, x0, u_init, *solve))
