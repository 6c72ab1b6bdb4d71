"""iLQR solves: pure and hybrid (transformer-accelerated).

Counterpart of ``quattro_tpu/solver/ilqr.py``. A Python loop replaces
``lax.while_loop``; the ``done`` flag decides the exit exactly as there.
Convergence contract: accept the first step size with cost <= current; stop
when no step is accepted OR |J_prev - J_new| < tol (with ``adaptive_reg``,
retry with a larger regularizer instead of stopping, up to ``reg_max``).

``ilqr_solve_fused`` runs the whole solve as one launch of kernel K3
(``ops/fused_solve.py``) with fixed ``max_iter`` masked trips.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts
from quattro_tpu_torch.solver.derivatives import (
    linearize_dynamics,
    quadratize_cost,
    quadratize_final_cost,
)
from quattro_tpu_torch.solver.riccati import (
    riccati_backward,
    riccati_backward_associative,
    riccati_backward_auto,
    riccati_backward_fused,
)
from quattro_tpu_torch.solver.rollout import (
    DEFAULT_ALPHAS,
    line_search,
    line_search_fused,
    simulate,
    trajectory_cost,
)

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]
# predict(x_err_seq (H+1, n), prompt (W, m*(1+n))) -> (H - W, m*(1+n)); batched solves give each a leading (B,)
GainPredictFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

class ILQRConfig(NamedTuple):
    """Solver configuration; same fields and defaults as the JAX package.

    ``riccati``: ``"auto"`` (``riccati_backward_auto``: K1 for a single
    trajectory on CUDA; on the CPU JAX's rule, the associative form for a
    single trajectory at H >= 16 and the sequential form otherwise),
    ``"seq"``, ``"fused"`` (K1 on CUDA, its plain form on the CPU) or
    ``"assoc"`` (the associative scan, two K8 launches per pass on CUDA; the
    legacy ``parallel_riccati=True`` selects it too). ``linesearch``:
    ``"xla"`` (the all-alpha rollout in PyTorch ops) or ``"fused"`` (K2 on CUDA).
    ``linesearch_unroll`` is accepted for parity and changes nothing;
    ``linesearch_fuse_cost`` sums the running cost inside the rollout.
    """

    max_iter: int = 100
    tol: float = 1e-3
    reg: float = 1e-6
    alphas: Tuple[float, ...] = DEFAULT_ALPHAS
    parallel_riccati: Optional[bool] = None
    adaptive_reg: bool = False
    reg_factor: float = 10.0
    reg_max: float = 1e2
    chol_solve: bool = True
    riccati: str = "auto"  # "auto" | "seq" | "assoc" | "fused"
    batch_hint: int = 1
    linesearch: str = "xla"  # "xla" | "fused"
    linesearch_unroll: int = 1
    linesearch_fuse_cost: bool = False


# Fail fast on typo'd mode strings at construction, on both construction
# paths: __new__ AND _replace (NamedTuple._replace bypasses a patched __new__).
_RICCATI_MODES = ("auto", "seq", "assoc", "fused")
_LINESEARCH_MODES = ("xla", "fused")
_config_new = ILQRConfig.__new__
_config_replace = ILQRConfig._replace


def _validate_config(self):
    if self.riccati not in _RICCATI_MODES:
        raise ValueError(f"Unknown riccati mode: {self.riccati!r} (auto|seq|assoc|fused)")
    if self.linesearch not in _LINESEARCH_MODES:
        raise ValueError(f"Unknown linesearch mode: {self.linesearch!r} (xla|fused)")
    if self.linesearch == "fused" and self.linesearch_unroll != 1:
        raise ValueError(
            "linesearch_unroll only affects linesearch='xla'; combining it with "
            f"linesearch='fused' has no effect (got linesearch_unroll={self.linesearch_unroll})"
        )
    if self.linesearch == "fused" and self.linesearch_fuse_cost:
        raise ValueError(
            "linesearch_fuse_cost only affects linesearch='xla' (the fused rollout "
            "evaluates costs outside the kernel); combining it with linesearch='fused' has no effect"
        )
    return self


def _validated_config_new(cls, *args, **kwargs):
    return _validate_config(_config_new(cls, *args, **kwargs))


def _validated_config_replace(self, **kwargs):
    return _validate_config(_config_replace(self, **kwargs))


ILQRConfig.__new__ = _validated_config_new
ILQRConfig._replace = _validated_config_replace


class ILQRSolution(NamedTuple):
    x_seq: torch.Tensor  # (H+1, n)
    u_seq: torch.Tensor  # (H, m)
    cost: torch.Tensor  # scalar
    iterations: int  # number of iterations executed
    converged: bool
    k_seq: torch.Tensor  # (H, m) gains from the last backward pass
    big_k_seq: torch.Tensor  # (H, m, n)


class ILQRLogs(NamedTuple):
    """Per-iteration solver telemetry, stacked over ``max_iter``.

    These drive observability and training-data generation. ``valid[i]``
    marks iterations actually executed; entries past them stay zero.
    """

    x_seq: torch.Tensor  # (max_iter, H+1, n) trajectory at iteration start
    u_seq: torch.Tensor  # (max_iter, H, m) controls after the iteration's update
    cost: torch.Tensor  # (max_iter,) cost at iteration start
    new_cost: torch.Tensor  # (max_iter,) cost after the update
    k_seq: torch.Tensor  # (max_iter, H, m)
    big_k_seq: torch.Tensor  # (max_iter, H, m, n)
    alpha: torch.Tensor  # (max_iter,) accepted step size (0 if none)
    found_update: torch.Tensor  # (max_iter,) bool
    valid: torch.Tensor  # (max_iter,) bool


def empty_logs(lead: Tuple[int, ...], horizon: int, n: int, m: int, dtype: torch.dtype, device) -> ILQRLogs:
    """Zero ``ILQRLogs`` whose fields lead with ``lead``: ``(max_iter,)`` for one solve, ``(B, max_iter)`` for a batch."""
    def zeros(*shape, dtype=dtype):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    return ILQRLogs(
        x_seq=zeros(horizon + 1, n), u_seq=zeros(horizon, m), cost=zeros(), new_cost=zeros(),
        k_seq=zeros(horizon, m), big_k_seq=zeros(horizon, m, n), alpha=zeros(),
        found_update=zeros(dtype=torch.bool), valid=zeros(dtype=torch.bool),
    )


def _backward(config: ILQRConfig):
    if config.parallel_riccati is not None:  # legacy boolean override
        return riccati_backward_associative if config.parallel_riccati else riccati_backward
    if config.riccati == "seq":
        return riccati_backward
    if config.riccati == "assoc":
        return riccati_backward_associative
    if config.riccati == "fused":
        return riccati_backward_fused
    return partial(riccati_backward_auto, batch_size=config.batch_hint)


def _line_search(config: ILQRConfig):
    if config.linesearch == "fused":
        return line_search_fused
    return partial(line_search, unroll=config.linesearch_unroll, fuse_cost=config.linesearch_fuse_cost)


def _ilqr_iteration(dynamics, cost, final_cost, config, x0, x_seq, u_seq, current_cost, reg=None):
    """One full iLQR iteration: linearize -> Riccati -> line search."""
    if reg is None:
        reg = config.reg
    a_seq, b_seq = linearize_dynamics(dynamics, x_seq, u_seq)
    cost_exp = quadratize_cost(cost, x_seq, u_seq)
    final_exp = quadratize_final_cost(final_cost, x_seq[-1])
    res = _backward(config)(a_seq, b_seq, cost_exp, final_exp.v_x, final_exp.v_xx, reg, config.chol_solve)
    alphas = torch.as_tensor(config.alphas, dtype=x_seq.dtype, device=x_seq.device)
    found, alpha, new_x, new_u, new_cost = _line_search(config)(
        dynamics, cost, final_cost, x0, x_seq, u_seq, res.k_seq, res.big_k_seq, current_cost, alphas,
    )
    return found, alpha, new_x, new_u, new_cost, res.k_seq, res.big_k_seq


def ilqr_solve(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    u_init: torch.Tensor,
    config: ILQRConfig = ILQRConfig(),
) -> ILQRSolution:
    """Pure iLQR with early exit. One host read of (found, |dJ|) per iteration."""
    x_seq = simulate(dynamics, x0, u_init)
    u_seq = u_init
    current_cost = trajectory_cost(cost, final_cost, x_seq, u_init)
    horizon, m = u_init.shape
    n = x0.shape[0]
    k_seq = u_init.new_zeros((horizon, m))
    big_k_seq = u_init.new_zeros((horizon, m, n))
    iteration, done, reg = 0, False, config.reg
    while iteration < config.max_iter and not done:
        found, _, new_x, new_u, new_cost, k_seq, big_k_seq = _ilqr_iteration(
            dynamics, cost, final_cost, config, x0, x_seq, u_seq, current_cost, reg=reg
        )
        found_h, small_h = (
            bool(v) for v in torch.stack([found, (current_cost - new_cost).abs() < config.tol]).cpu()
        )
        if config.adaptive_reg:
            # LM mu-schedule: shrink on success, grow and RETRY on failure;
            # terminate only when converged or mu saturates.
            reg_next = max(reg / config.reg_factor, config.reg) if found_h else min(reg * config.reg_factor, config.reg_max)
            done = (found_h and small_h) or (not found_h and reg >= config.reg_max)
            reg = reg_next
        else:
            done = (not found_h) or small_h
        x_seq, u_seq, current_cost = new_x, new_u, new_cost
        iteration += 1
    return ILQRSolution(x_seq, u_seq, current_cost, iteration, done, k_seq, big_k_seq)


def _initial_rollout(dynamics: Dynamics, x0: torch.Tensor, u_init: torch.Tensor) -> torch.Tensor:
    """The open-loop rollout of ``u_init``, (H+1, n).

    On the card it is one K2 launch with zero gains and the single step size
    1 (u_t = u_init_t exactly), where ``simulate`` is a few hundred small
    launches per time step; a plant K2 does not carry raises ``ValueError``
    there, as it would in K3. CPU tensors take ``simulate``.
    """
    if not x0.is_cuda:
        return simulate(dynamics, x0, u_init)
    horizon, m = u_init.shape
    n = x0.shape[0]
    cand_x, _ = fused_feedback_rollouts(
        dynamics, x0, x0.new_zeros((horizon, n)), u_init, u_init.new_zeros((horizon, m)),
        u_init.new_zeros((horizon, m, n)), x0.new_ones((1,)),
    )
    return cand_x[0]


def ilqr_solve_fused(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    u_init: torch.Tensor,
    config: ILQRConfig = ILQRConfig(),
) -> ILQRSolution:
    """``ilqr_solve`` with every iteration phase inside one kernel (K3).

    Linearization and quadratization, the backward Riccati pass, the all-alpha
    line search and the convergence bookkeeping run as one launch of
    ``ops/fused_solve.py`` with fixed ``config.max_iter`` masked trips: the
    same convergence semantics as ``ilqr_solve`` and a step latency that does
    not depend on the data. One host read (of ``stats``) per solve.

    Constraints: static ``reg`` (no ``adaptive_reg``); on CUDA the dynamics
    and costs must be ones the kernel knows (see ``fused_ilqr_solve_kernel``);
    ``config.riccati``/``linesearch`` are ignored (everything is fused). On
    CPU tensors the kernel's plain PyTorch form runs.
    """
    from quattro_tpu_torch.ops.fused_solve import fused_ilqr_solve_kernel

    if config.adaptive_reg:
        raise ValueError(
            "ilqr_solve_fused runs every trip with the one reg it is given (the kernel "
            "carries no mu-schedule); adaptive_reg needs ilqr_solve"
        )
    x_init = _initial_rollout(dynamics, x0, u_init)
    cost_init = trajectory_cost(cost, final_cost, x_init, u_init)
    x_seq, u_seq, k_seq, big_k_seq, stats = fused_ilqr_solve_kernel(
        dynamics, cost, final_cost, x_init, u_init, cost_init,
        config.max_iter, config.tol, config.reg, tuple(config.alphas),
    )
    _, iterations, converged = stats[0].tolist()
    return ILQRSolution(x_seq, u_seq, stats[0, 0], int(iterations), converged > 0.5, k_seq, big_k_seq)


def ilqr_solve_with_logs(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0: torch.Tensor,
    u_init: torch.Tensor,
    config: ILQRConfig = ILQRConfig(),
) -> Tuple[ILQRSolution, ILQRLogs]:
    """Pure iLQR with early exit, emitting per-iteration logs.

    Used by the training-data pipeline. Log buffers have a fixed ``max_iter``
    capacity and are written at the iteration index; entries past
    ``iterations`` keep their zero-init and ``valid=False``.
    """
    x_seq = simulate(dynamics, x0, u_init)
    u_seq = u_init
    current_cost = trajectory_cost(cost, final_cost, x_seq, u_init)
    horizon, m = u_init.shape
    n = x0.shape[0]
    mi = config.max_iter

    logs = empty_logs((mi,), horizon, n, m, x_seq.dtype, x0.device)
    iteration, done, reg = 0, False, config.reg
    while iteration < mi and not done:
        found, alpha, new_x, new_u, new_cost, k_seq, big_k_seq = _ilqr_iteration(
            dynamics, cost, final_cost, config, x0, x_seq, u_seq, current_cost, reg=reg
        )
        found_h, small_h = (
            bool(v) for v in torch.stack([found, (current_cost - new_cost).abs() < config.tol]).cpu()
        )
        if config.adaptive_reg:
            # Same LM mu-schedule as ilqr_solve: a failed line search grows mu and retries.
            reg_next = max(reg / config.reg_factor, config.reg) if found_h else min(reg * config.reg_factor, config.reg_max)
            done = (found_h and small_h) or (not found_h and reg >= config.reg_max)
            reg = reg_next
        else:
            done = (not found_h) or small_h
        entry = ILQRLogs(x_seq, new_u, current_cost, new_cost, k_seq, big_k_seq, alpha, found, True)
        for buf, val in zip(logs, entry):
            buf[iteration] = val
        x_seq, u_seq, current_cost = new_x, new_u, new_cost
        iteration += 1
    # Final gains: last valid backward pass.
    last = max(iteration - 1, 0)
    solution = ILQRSolution(x_seq, u_seq, current_cost, iteration, done, logs.k_seq[last], logs.big_k_seq[last])
    return solution, logs


def pack_gain_tokens(k_seq: torch.Tensor, big_k_seq: torch.Tensor) -> torch.Tensor:
    """Gain tokens interleaved per control channel: ``[k_0, K[0, :], k_1, K[1, :], ...]``.

    (T, m), (T, m, n) -> (T, m(1+n)); leading batch axes pass through.
    """
    return torch.cat([k_seq[..., None], big_k_seq], dim=-1).flatten(-2)


def unpack_gain_tokens(tokens: torch.Tensor, m: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_gain_tokens``: (..., T, m(1+n)) -> k (..., T, m), K (..., T, m, n)."""
    kk = tokens.unflatten(-1, (m, 1 + n))
    return kk[..., 0], kk[..., 1:]


def hybrid_ilqr_solve(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    predict_fn: GainPredictFn,
    window: int,
    x0: torch.Tensor,
    u_init: torch.Tensor,
    x_ref: torch.Tensor,
    config: ILQRConfig = ILQRConfig(),
    state_offset: Optional[torch.Tensor] = None,
    exact_fallback: bool = False,
) -> ILQRSolution:
    """Transformer-accelerated iLQR.

    Per iteration: the exact Riccati pass over only the LAST ``window`` steps,
    those tail gains packed as the prompt, the model's prediction of the
    first ``H - window`` gains from the state-error trajectory
    ``x_seq - x_ref + state_offset``, then the standard line search.

    ``exact_fallback``: an iteration that would end the solve (no step
    accepted, or |dJ| < tol) is redone with the exact full-horizon backward
    pass, and only an exact iteration that also fails to improve ends it.
    Predicted gains are promoted to the exact tail's dtype.
    """
    if state_offset is None:
        state_offset = torch.zeros_like(x0)
    x_seq = simulate(dynamics, x0, u_init)
    u_seq = u_init
    current_cost = trajectory_cost(cost, final_cost, x_seq, u_init)
    horizon, m = u_init.shape
    n = x0.shape[0]
    alphas = torch.as_tensor(config.alphas, dtype=x0.dtype, device=x0.device)

    def hybrid_iteration(x_seq, u_seq, current_cost):
        tail_x = x_seq[horizon - window :]
        tail_u = u_seq[horizon - window :]
        a_tail, b_tail = linearize_dynamics(dynamics, tail_x, tail_u)
        tail_exp = quadratize_cost(cost, tail_x, tail_u)
        final_exp = quadratize_final_cost(final_cost, x_seq[-1])
        res = riccati_backward(
            a_tail, b_tail, tail_exp, final_exp.v_x, final_exp.v_xx, config.reg, config.chol_solve
        )
        prompt = pack_gain_tokens(res.k_seq, res.big_k_seq)  # (window, m(1+n))
        predicted = predict_fn(x_seq - x_ref + state_offset, prompt)  # (H - window, m(1+n))
        k_head, big_k_head = unpack_gain_tokens(predicted.to(res.k_seq.dtype), m, n)
        k_full = torch.cat([k_head, res.k_seq])
        big_k_full = torch.cat([big_k_head, res.big_k_seq])
        found, _, new_x, new_u, new_cost = _line_search(config)(
            dynamics, cost, final_cost, x0, x_seq, u_seq, k_full, big_k_full, current_cost, alphas,
        )
        return found, new_x, new_u, new_cost, k_full, big_k_full

    def stops(found, new_cost, current_cost):
        f, small = (bool(v) for v in torch.stack([found, (current_cost - new_cost).abs() < config.tol]).cpu())
        return (not f) or small

    k_seq = u_init.new_zeros((horizon, m))
    big_k_seq = u_init.new_zeros((horizon, m, n))
    iteration, done = 0, False
    while iteration < config.max_iter and not done:
        found, new_x, new_u, new_cost, k_new, big_k_new = hybrid_iteration(x_seq, u_seq, current_cost)
        done = stops(found, new_cost, current_cost)
        if exact_fallback and done:
            # Redo this iteration exactly; terminate only if IT cannot improve.
            found, _, new_x, new_u, new_cost, k_new, big_k_new = _ilqr_iteration(
                dynamics, cost, final_cost, config, x0, x_seq, u_seq, current_cost
            )
            done = stops(found, new_cost, current_cost)
        x_seq, u_seq, current_cost, k_seq, big_k_seq = new_x, new_u, new_cost, k_new, big_k_new
        iteration += 1
    return ILQRSolution(x_seq, u_seq, current_cost, iteration, done, k_seq, big_k_seq)
