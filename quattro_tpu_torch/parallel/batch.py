"""Trajectory-batch iLQR: thousands of independent problems in one call.

Counterpart of ``quattro_tpu/parallel/batch.py::batched_ilqr_solve``. Both
backends are one masked loop over the batch, the loop that ``vmap`` of the
JAX ``while_loop`` runs: one shared trip counter, lanes that are done keep
their carry frozen, per-lane iteration counts, and one host read of
``done.all()`` per trip. They differ in the backward pass:

- ``"fused"`` / ``"fused_bf16"``: one batched backward-pass launch per trip
  (kernel K4, ``ops/fused_riccati.py``), the stage inputs streamed in
  bfloat16 for ``"fused_bf16"``;
- ``"vmap"``: the solver's own backward pass (``ILQRConfig.riccati``) under
  ``torch.func.vmap``, with a per-lane ``reg`` for ``adaptive_reg``; the
  associative form runs batched instead (two K8 launches per trip).

The derivatives run under ``torch.func.vmap``; the line search is
``vmap(line_search)`` or, with ``linesearch="fused"``, one batched rollout
launch per trip (kernel K7, ``solver/rollout.py::line_search_batched_fused``).

``batched_ilqr_solve_with_logs`` runs the same loop and also writes each
trip's entry into per-lane log buffers (the training-data collection's solve).

``batched_hybrid_ilqr_solve`` is ``vmap(hybrid_ilqr_solve)``: the same masked
loop around the transformer-accelerated trip (the exact pass over the tail
window of every lane in one K4 launch where K4 takes the shape, one predictor
forward over the batch, the batched line search).

``sharded_ilqr_solve`` cuts the batch over a device mesh and runs
``batched_ilqr_solve`` on each shard.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops.fused_riccati import MAX_M, MAX_N, riccati_backward_batched_fused_auto
from quattro_tpu_torch.parallel.mesh import GlobalArray, Mesh, assemble, shard
from quattro_tpu_torch.solver.derivatives import linearize_dynamics, quadratize_cost, quadratize_final_cost
from quattro_tpu_torch.solver.ilqr import (
    GainPredictFn, ILQRConfig, ILQRLogs, ILQRSolution, _backward, empty_logs, pack_gain_tokens, unpack_gain_tokens,
)
from quattro_tpu_torch.solver.riccati import auto_form, riccati_backward, riccati_backward_associative
from quattro_tpu_torch.solver.rollout import line_search, line_search_batched_fused, simulate, trajectory_cost

BACKENDS = ("auto", "fused", "fused_bf16", "vmap")

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FinalCost = Callable[[torch.Tensor], torch.Tensor]


def _fused_backend_applies(config: ILQRConfig, x0_batch, u_init_batch, device_type: Optional[str] = None) -> bool:
    """Whether ``"auto"`` takes the fused backward pass (K4).

    JAX's conditions with a CUDA device in place of the TPU backend: float32
    data, a batch of at least 8, small (n, m), a static reg (the kernel carries
    no mu-schedule) and the solver's algorithm knobs on their defaults, so a
    pinned ``riccati=``/``parallel_riccati`` is never swapped for the fused
    law; ``linesearch="fused"`` composes. ``device_type`` defaults to the
    batch's device.
    """
    if device_type is None:
        device_type = x0_batch.device.type
    n = x0_batch.shape[-1]
    m = u_init_batch.shape[-1]
    return (
        device_type == "cuda"
        and x0_batch.dtype == torch.float32
        and u_init_batch.dtype == torch.float32
        and x0_batch.shape[0] >= 8
        and n <= MAX_N
        and m <= MAX_M
        and not config.adaptive_reg
        and config.riccati == "auto"
        and config.parallel_riccati is None
        and config.linesearch in ("xla", "fused")
    )


def batched_ilqr_solve(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0_batch: torch.Tensor,  # (B, n)
    u_init_batch: torch.Tensor,  # (B, H, m)
    config: ILQRConfig = ILQRConfig(),
    riccati_backend: str = "auto",
) -> ILQRSolution:
    """Solve a batch of independent iLQR problems.

    ``riccati_backend``: ``"fused"`` (chosen by ``"auto"`` for float32 CUDA
    batches of 8 or more, see ``_fused_backend_applies``), ``"fused_bf16"``
    (bfloat16 stage inputs, about 1e-3 relative error on the gains; never
    chosen by ``"auto"``) or ``"vmap"``. The two are equal in exact
    arithmetic: float64 gives equal iterations and accepts. In float32 their
    summation orders differ, which can flip a near-tie accept on single lanes
    after a few iterations; both results are valid solves.

    A forced ``"fused"`` on CPU tensors runs the kernels' plain forms. With
    ``"vmap"``, lanes that would reach K1 (``riccati="fused"``, or ``"auto"``
    on the card for a batch of one) and lanes with ``linesearch="fused"``
    take K4 and K7, which run K1's and K2's per-lane law: K1 and K2 launch
    through ctypes and cannot run under ``torch.func.vmap``. For the same
    reason a pinned ``riccati="assoc"`` (or ``parallel_riccati=True``, or
    ``"auto"`` on the CPU for a batch of one at H >= 16) runs the associative
    form batched over the (B, H) stage tensors, not under ``vmap``: two K8
    launches per trip on CUDA, each over all B * H systems, with the per-lane
    ``reg`` (B,) of ``adaptive_reg`` broadcast into ``l_uu + reg I``. Every
    operation of that form acts on each lane alone, so the result equals
    ``vmap`` of the per-lane form (up to the summation order of batched
    matrix products).

    Returns an ``ILQRSolution`` with a leading batch axis; ``iterations``
    (int32) and ``converged`` (bool) are (B,) tensors.
    """
    config, backward = _select_backend(config, x0_batch, u_init_batch, riccati_backend)
    trip = _exact_trips(dynamics, cost, final_cost, x0_batch, config, backward)
    return _masked_solve(dynamics, cost, final_cost, x0_batch, u_init_batch, config, trip)


def batched_ilqr_solve_with_logs(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0_batch: torch.Tensor,  # (B, n)
    u_init_batch: torch.Tensor,  # (B, H, m)
    config: ILQRConfig = ILQRConfig(),
    riccati_backend: str = "auto",
    logs: Optional[ILQRLogs] = None,
) -> Tuple[ILQRSolution, ILQRLogs]:
    """``batched_ilqr_solve`` that also logs every trip: ``vmap(ilqr_solve_with_logs)``'s semantics.

    The same dispatch, refusals and loop as ``batched_ilqr_solve`` (on the
    "fused" backend one K4 launch per trip, and one K7 with
    ``linesearch="fused"``). Trip ``t`` writes entry ``t`` of the lanes that
    are active at its start, which is each such lane's iteration ``t``: the
    trip's starting x, the new u, the cost and new cost, k, K, the accepted
    step size, whether a step was accepted, and ``valid``. Entries after a
    lane's last iteration stay zero with ``valid=False``, as in the single
    ``ilqr_solve_with_logs``.

    ``logs``: zero-filled buffers of shape ``(B, max_iter, ...)`` to write
    into (views of a larger buffer work); ``None`` allocates them.
    """
    config, backward = _select_backend(config, x0_batch, u_init_batch, riccati_backend)
    if logs is None:
        batch, horizon, m = u_init_batch.shape
        logs = empty_logs((batch, config.max_iter), horizon, x0_batch.shape[-1], m, x0_batch.dtype, x0_batch.device)
    trip = _exact_trips(dynamics, cost, final_cost, x0_batch, config, backward)
    solution = _masked_solve(dynamics, cost, final_cost, x0_batch, u_init_batch, config, trip, logs)
    return solution, logs


def _select_backend(config: ILQRConfig, x0_batch: torch.Tensor, u_init_batch: torch.Tensor, riccati_backend: str):
    """``(config, backward)`` for the masked loop: the backend's refusals and the dispatch of ``"auto"``."""
    if riccati_backend not in BACKENDS:
        raise ValueError(f"Unknown riccati_backend: {riccati_backend!r}")
    n, m = x0_batch.shape[-1], u_init_batch.shape[-1]
    if riccati_backend in ("fused", "fused_bf16"):
        # Forcing the kernel is as loud as the auto dispatch is careful.
        if config.adaptive_reg:
            raise ValueError(
                f"riccati_backend={riccati_backend!r} runs every trip with the one reg it "
                "is given (the kernel carries no mu-schedule); the adaptive LM mu-schedule "
                "needs riccati_backend='vmap'"
            )
        if config.riccati != "auto" or config.parallel_riccati is not None:
            raise ValueError(
                f"riccati_backend={riccati_backend!r} runs the fused sequential-law kernel; "
                "pinned riccati=/parallel_riccati settings conflict — use riccati_backend='vmap'"
            )
        if n > MAX_N or m > MAX_M:
            raise ValueError(
                f"riccati_backend={riccati_backend!r} supports n <= {MAX_N}, m <= {MAX_M} (got n={n}, m={m})"
            )
        if x0_batch.is_cuda and x0_batch.dtype not in (torch.float32, torch.float64):
            raise ValueError(
                f"riccati_backend={riccati_backend!r} on CUDA requires float32 or float64 data "
                f"(got {x0_batch.dtype})"
            )
    use_fused = riccati_backend in ("fused", "fused_bf16") or (
        riccati_backend == "auto" and _fused_backend_applies(config, x0_batch, u_init_batch)
    )
    if use_fused:
        # One K4 launch per trip on CUDA.
        stream_dtype = torch.bfloat16 if riccati_backend == "fused_bf16" else None

        def fused(a, b, exp, v_x, v_xx, reg):
            return riccati_backward_batched_fused_auto(a, b, exp, v_x, v_xx, config.reg, stream_dtype=stream_dtype)

        return config, fused
    if config.parallel_riccati is None and config.riccati == "auto":
        config = config._replace(batch_hint=max(config.batch_hint, x0_batch.shape[0]))
    return config, _lane_backward(config, x0_batch, u_init_batch)


def _lane_backward(config: ILQRConfig, x0_batch: torch.Tensor, u_init_batch: torch.Tensor):
    """The ``"vmap"`` backend's backward pass over the batch: ``(a, b, exp, v_x, v_xx, reg) -> (k, K)``.

    The form is the per-lane solver's (``ILQRConfig.riccati``, ``"auto"``
    resolved as ``riccati_backward_auto`` resolves it for one lane). Lanes
    that would reach K1 take K4; the associative form runs batched, on the
    (B, H, ...) stage tensors directly; the sequential form runs under
    ``torch.func.vmap``.
    """
    n, (horizon, m) = x0_batch.shape[-1], u_init_batch.shape[1:]
    if config.parallel_riccati is not None:  # legacy boolean override
        form = "assoc" if config.parallel_riccati else "seq"
    elif config.riccati == "auto":
        form = auto_form(horizon, n, m, x0_batch.is_cuda, config.batch_hint)
    else:
        form = config.riccati
    if form == "fused":
        if config.adaptive_reg and config.riccati == "fused":
            raise ValueError(
                "riccati='fused' runs every trip with the one reg it is given; the adaptive "
                "LM mu-schedule needs riccati='seq'|'auto'"
            )

        def fused(a, b, exp, v_x, v_xx, reg):
            return riccati_backward_batched_fused_auto(a, b, exp, v_x, v_xx, config.reg)

        return fused
    if form == "assoc":

        def assoc(a, b, exp, v_x, v_xx, reg):
            res = riccati_backward_associative(a, b, exp, v_x, v_xx, reg, config.chol_solve)
            return res.k_seq, res.big_k_seq

        return assoc
    # reg is a (B,) tensor under adaptive_reg (see _exact_trips), else the static float.
    per_lane = vmap(partial(_backward(config), use_chol=config.chol_solve),
                    in_dims=(0, 0, 0, 0, 0, 0 if config.adaptive_reg else None))

    def lanes(a, b, exp, v_x, v_xx, reg):
        res = per_lane(a, b, exp, v_x, v_xx, reg)
        return res.k_seq, res.big_k_seq

    return lanes


def _masked_solve(dynamics, cost, final_cost, x0_batch, u_init_batch, config: ILQRConfig, trip,
                  logs: Optional[ILQRLogs] = None) -> ILQRSolution:
    """``vmap`` of a per-lane solve loop as one loop over the batch (see the module docstring).

    ``trip(xs, us, cs, active) -> (found, alpha, new_x, new_u, new_cost, k,
    big_k, now_done)`` is one iteration of every lane (``_exact_trips``,
    ``_hybrid_trips``); the loop keeps what it returns for the active lanes
    only. With ``logs`` (``(B, max_iter, ...)`` buffers) each trip also writes
    its entry for the lanes active at its start (``batched_ilqr_solve_with_logs``).
    """
    batch, horizon, m = u_init_batch.shape
    n = x0_batch.shape[-1]
    xs, cs = _initial_batch(dynamics, cost, final_cost, x0_batch, u_init_batch)
    us = u_init_batch
    ks = u_init_batch.new_zeros((batch, horizon, m))
    big_ks = u_init_batch.new_zeros((batch, horizon, m, n))
    done = torch.zeros(batch, dtype=torch.bool, device=xs.device)
    iters = torch.zeros(batch, dtype=torch.int32, device=xs.device)
    t = 0
    while t < config.max_iter and not bool(done.all()):  # the trip's one host read
        active = ~done
        found, alpha, new_x, new_u, new_cost, k, big_k, now_done = trip(xs, us, cs, active)
        if logs is not None:
            entry = (xs, new_u, cs, new_cost, k, big_k, alpha, found, active)
            for buf, value in zip(logs, entry):
                slot = buf[:, t]
                slot.copy_(_keep_active(active, (value,), (slot,))[0])
        xs, us, cs, ks, big_ks = _keep_active(active, (new_x, new_u, new_cost, k, big_k), (xs, us, cs, ks, big_ks))
        done = done | now_done
        iters = iters + active.to(iters.dtype)
        t += 1
    return ILQRSolution(xs, us, cs, iters, done, ks, big_ks)


def _keep_active(active: torch.Tensor, new, old):
    """Each of ``new`` on the ``active`` lanes and the matching one of ``old`` elsewhere."""
    return tuple(torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new, old))


def _initial_batch(dynamics, cost, final_cost, x0_batch, u_init_batch):
    """The open-loop rollouts of the warm starts and their costs."""
    xs = vmap(partial(simulate, dynamics))(x0_batch, u_init_batch)
    return xs, vmap(partial(trajectory_cost, cost, final_cost))(xs, u_init_batch)


def _alphas(config: ILQRConfig, x0_batch: torch.Tensor) -> torch.Tensor:
    """The line search's step sizes."""
    return torch.as_tensor(config.alphas, dtype=x0_batch.dtype, device=x0_batch.device)


def _batched_line_search(dynamics, cost, final_cost, config: ILQRConfig):
    """``(x0, xs, us, k, big_k, cs, alphas) -> (found, alpha, new_x, new_u, new_cost)`` over a batch.

    One K7 launch with ``linesearch="fused"``, else ``vmap(line_search)``.
    """
    if config.linesearch == "fused":
        return partial(line_search_batched_fused, dynamics, cost, final_cost)
    lane = partial(line_search, dynamics, cost, final_cost, unroll=config.linesearch_unroll,
                   fuse_cost=config.linesearch_fuse_cost)
    return vmap(lane, in_dims=(0, 0, 0, 0, 0, 0, None))


def _derivatives(dynamics, cost, final_cost, xs, us):
    """Every lane's stage Jacobians and cost expansion, and the final cost's at ``xs[:, -1]``."""
    a, b = vmap(partial(linearize_dynamics, dynamics))(xs, us)
    exp = vmap(partial(quadratize_cost, cost))(xs, us)
    fexp = vmap(partial(quadratize_final_cost, final_cost))(xs[:, -1])
    return a, b, exp, fexp


def _exact_trip(dynamics, cost, final_cost, backward, search, x0, xs, us, cs, reg, alphas):
    """One full-horizon iLQR iteration of every lane: ``(found, alpha, new_x, new_u, new_cost, k, big_k)``."""
    a, b, exp, fexp = _derivatives(dynamics, cost, final_cost, xs, us)
    k, big_k = backward(a, b, exp, fexp.v_x, fexp.v_xx, reg)
    return (*search(x0, xs, us, k, big_k, cs, alphas), k, big_k)


def _exact_trips(dynamics, cost, final_cost, x0_batch, config: ILQRConfig, backward):
    """``_masked_solve``'s trip for ``vmap(ilqr_solve)``: the full-horizon iteration and its stopping rule.

    Under ``adaptive_reg`` the trip carries JAX's per-lane reg: the LM
    mu-schedule shrinks it on success and grows it on failure, and a lane ends
    only when it converges or its mu saturates. Otherwise every trip runs at
    the static ``config.reg``.
    """
    search, alphas = _batched_line_search(dynamics, cost, final_cost, config), _alphas(config, x0_batch)
    reg = (torch.full((x0_batch.shape[0],), config.reg, dtype=x0_batch.dtype, device=x0_batch.device)
           if config.adaptive_reg else config.reg)

    def trip(xs, us, cs, active):
        nonlocal reg
        found, alpha, new_x, new_u, new_cost, k, big_k = _exact_trip(
            dynamics, cost, final_cost, backward, search, x0_batch, xs, us, cs, reg, alphas)
        small = (cs - new_cost).abs() < config.tol
        if config.adaptive_reg:
            reg_next = torch.where(found, torch.clamp(reg / config.reg_factor, min=config.reg),
                                   torch.clamp(reg * config.reg_factor, max=config.reg_max))
            now_done = (found & small) | (~found & (reg >= config.reg_max))
            reg = torch.where(active, reg_next, reg)
        else:
            now_done = ~found | small
        return found, alpha, new_x, new_u, new_cost, k, big_k, now_done

    return trip


def batched_hybrid_ilqr_solve(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    predict_fn: GainPredictFn,
    window: int,
    x0_batch: torch.Tensor,  # (B, n)
    u_init_batch: torch.Tensor,  # (B, H, m)
    x_ref: torch.Tensor,
    config: ILQRConfig = ILQRConfig(),
    state_offset: Optional[torch.Tensor] = None,
    exact_fallback: bool = False,
    riccati_backend: str = "auto",
) -> ILQRSolution:
    """A batch of transformer-accelerated solves: ``vmap(hybrid_ilqr_solve)``'s semantics.

    Each lane's result is that lane's ``hybrid_ilqr_solve``. ``_masked_solve``'s
    loop (finished lanes frozen, per-lane ``iterations`` and ``converged``, one
    host read of ``done.all()`` per trip) around a trip that is: the
    derivatives of the last ``window`` steps of every lane under
    ``torch.func.vmap``; the tail's exact backward pass over all lanes
    (``_tail_backward``: one K4 launch on CUDA where K4 takes the shape); the
    tail gains packed as each lane's prompt; one ``predict_fn`` call over the
    batch, ``(B, H+1, n), (B, window, m(1+n)) -> (B, H - window, m(1+n))``,
    on the state errors ``x_seq - x_ref + state_offset`` (``x_ref`` and
    ``state_offset`` shared by the lanes), its output promoted to the tail's
    dtype; then the line search over [head, tail] (one K7 launch with
    ``linesearch="fused"``). Like JAX's hybrid solve, the tail runs the
    sequential law whatever ``config.riccati`` says, at the static
    ``config.reg``.

    ``exact_fallback``: the active lanes whose hybrid step would end them (no
    step accepted, or |dJ| < tol) redo the iteration exactly, over the full
    horizon, and only that iteration's verdict can end them. Those lanes are
    gathered (a second host read per trip) and solved together, so a
    trip in which no lane needs it launches nothing more, and the exact pass
    costs the lanes that need it rather than the batch. Its backward pass is
    the batched backend's (``riccati_backend``, dispatched as
    ``batched_ilqr_solve`` dispatches it), chosen once for the whole batch:
    a gathered subset of fewer than 8 lanes keeps the fused K4 pass that
    "auto" picks for a float32 CUDA batch of 8 or more. Where a lane's two
    branches differ in dtype, the carry takes the wider one, as JAX's
    ``lax.cond`` promotion does.

    Returns an ``ILQRSolution`` with a leading batch axis, as
    ``batched_ilqr_solve`` returns.
    """
    trip = _hybrid_trips(dynamics, cost, final_cost, predict_fn, window, x0_batch, u_init_batch, x_ref, config,
                         state_offset, exact_fallback, riccati_backend)
    return _masked_solve(dynamics, cost, final_cost, x0_batch, u_init_batch, config, trip)


def _tail_backward(config: ILQRConfig, x0_batch: torch.Tensor, u_init_batch: torch.Tensor):
    """The hybrid trip's exact pass over the tail window: ``(a, b, exp, v_x, v_xx) -> (k, K)``.

    JAX's tail pass is the sequential law with ``chol_solve``, per lane. K4
    computes that law (with its own Cholesky) for every lane in one launch,
    so it takes the tail wherever it takes the shape: n <= 16 and m <= 8, and
    on CUDA float32 or float64 data (on the CPU, its plain form). Elsewhere
    the sequential pass runs under ``torch.func.vmap``.
    """
    n, m = x0_batch.shape[-1], u_init_batch.shape[-1]
    if n <= MAX_N and m <= MAX_M and (not x0_batch.is_cuda or x0_batch.dtype in (torch.float32, torch.float64)):
        return partial(riccati_backward_batched_fused_auto, reg=config.reg)
    per_lane = vmap(partial(riccati_backward, reg=config.reg, use_chol=config.chol_solve))

    def lanes(a, b, exp, v_x, v_xx):
        res = per_lane(a, b, exp, v_x, v_xx)
        return res.k_seq, res.big_k_seq

    return lanes


def _hybrid_gains(predict_fn, xs, x_ref, state_offset, k_tail, big_k_tail):
    """The full-horizon gains of every lane: the predicted head, from the tail gains as the prompt, then the tail."""
    m, n = big_k_tail.shape[-2:]
    predicted = predict_fn(xs - x_ref + state_offset, pack_gain_tokens(k_tail, big_k_tail))
    k_head, big_k_head = unpack_gain_tokens(predicted.to(k_tail.dtype), m, n)
    return torch.cat([k_head, k_tail], dim=1), torch.cat([big_k_head, big_k_tail], dim=1)


def _hybrid_trips(dynamics, cost, final_cost, predict_fn, window, x0_batch, u_init_batch, x_ref,
                  config: ILQRConfig, state_offset, exact_fallback, riccati_backend):
    """``_masked_solve``'s trip for ``vmap(hybrid_ilqr_solve)``, the exact fallback included."""
    head = u_init_batch.shape[1] - window
    if state_offset is None:
        state_offset = torch.zeros_like(x0_batch[0])
    # Every iteration of a hybrid solve runs at config.reg: no mu-schedule for the exact one either.
    _, exact_backward = _select_backend(config._replace(adaptive_reg=False), x0_batch, u_init_batch, riccati_backend)
    tail_backward = _tail_backward(config, x0_batch, u_init_batch)
    search, alphas = _batched_line_search(dynamics, cost, final_cost, config), _alphas(config, x0_batch)

    def trip(xs, us, cs, active):
        a, b, exp, fexp = _derivatives(dynamics, cost, final_cost, xs[:, head:], us[:, head:])
        k_tail, big_k_tail = tail_backward(a, b, exp, fexp.v_x, fexp.v_xx)
        k, big_k = _hybrid_gains(predict_fn, xs, x_ref, state_offset, k_tail, big_k_tail)
        found, alpha, new_x, new_u, new_cost = search(x0_batch, xs, us, k, big_k, cs, alphas)
        now_done = ~found | ((cs - new_cost).abs() < config.tol)
        if exact_fallback:
            lanes = torch.nonzero(active & now_done).squeeze(1)  # host read: the lanes to redo exactly
            now_done = torch.zeros_like(now_done)
            if lanes.numel():
                exact = _exact_trip(dynamics, cost, final_cost, exact_backward, search, x0_batch[lanes], xs[lanes],
                                    us[lanes], cs[lanes], config.reg, alphas)
                found, alpha, new_x, new_u, new_cost, k, big_k = (
                    _put_lanes(h, lanes, e) for h, e in zip((found, alpha, new_x, new_u, new_cost, k, big_k), exact))
                now_done[lanes] = ~exact[0] | ((cs[lanes] - exact[4]).abs() < config.tol)
        return found, alpha, new_x, new_u, new_cost, k, big_k, now_done

    return trip


def _put_lanes(hybrid: torch.Tensor, lanes: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """``hybrid`` with rows ``lanes`` replaced by ``exact``, in the wider of the two dtypes."""
    dtype = torch.promote_types(hybrid.dtype, exact.dtype)
    return hybrid.to(dtype).index_put((lanes,), exact.to(dtype))


def sharded_ilqr_solve(
    dynamics: Dynamics,
    cost: RunningCost,
    final_cost: FinalCost,
    x0_batch,  # (B, n): a tensor or a GlobalArray laid out by (axis,)
    u_init_batch,  # (B, H, m), likewise
    mesh: Mesh,
    config: ILQRConfig = ILQRConfig(),
    axis: str = "traj",
) -> ILQRSolution:
    """Batch solve with the batch axis sharded over ``axis`` of the mesh.

    B must be divisible by the axis size. Each shard runs
    ``batched_ilqr_solve`` on its own lanes, on its own device, with no
    communication: the auto dispatch sees the local width (on CUDA, float32
    shards of 8 lanes or more take K4, and K7 with ``linesearch="fused"``,
    one launch each per trip of the shard), and each shard iterates until
    its own lanes are done. Both match ``batched_ilqr_solve`` lane for lane.

    The shards a process holds must all lie on one device (a virtual mesh,
    or one card per process through ``distributed.global_mesh``):
    ``dynamics``, ``cost`` and ``final_cost`` keep the tensors they hold on
    the device they were built on, and the shards run one after another, so
    several cards in one process would not overlap. Such a mesh raises a
    ``ValueError``.

    Returns the solution gathered back along the batch axis on
    ``x0_batch``'s device, or, for ``GlobalArray`` inputs, each field as a
    ``GlobalArray`` of this process's shards.
    """
    coords = mesh.coords((axis,))
    devices = sorted({str(mesh.device(c)) for c in coords if mesh.is_local(c)})
    if len(devices) > 1:
        raise ValueError(f"sharded_ilqr_solve runs the shards of one process on one device, but this process's "
                         f"shards of axis {axis!r} lie on {devices}: run one process per device "
                         "(distributed.global_mesh) or a virtual mesh over one device")
    x0s, us = shard(x0_batch, mesh, (axis,), coords), shard(u_init_batch, mesh, (axis,), coords)
    sols = {c: batched_ilqr_solve(dynamics, cost, final_cost, x0s[c], us[c], config) for c in x0s}
    fields = [{c: sol[i] for c, sol in sols.items()} for i in range(len(ILQRSolution._fields))]
    if isinstance(x0_batch, GlobalArray):
        batch, n = x0_batch.shape
        horizon, m = u_init_batch.shape[1:]
        shapes = ((batch, horizon + 1, n), (batch, horizon, m), (batch,), (batch,), (batch,), (batch, horizon, m),
                  (batch, horizon, m, n))
        return ILQRSolution(*(GlobalArray(f, mesh, (axis,), s) for f, s in zip(fields, shapes)))
    return ILQRSolution(*(assemble(f, mesh, (axis,), x0_batch.device) for f in fields))
