"""All-alpha closed-loop rollouts (kernels K2, K6, K7) and their plain forms.

Counterparts of ``quattro_tpu/ops/fused_rollout.py``:

    u_t = u_ref_t + alpha * (k_t + K_t (x_t - x_ref_t));  x_{t+1} = f(x_t, u_t)

for every alpha at once. ``fused_feedback_rollouts`` (K2) rolls out one
trajectory, returning ``(cand_x (A, H+1, n), cand_u (A, H, m))``;
``fused_feedback_rollouts_batched`` (K7) and
``fused_feedback_rollouts_batched2d`` (K6) roll out a batch, returning
``(A, B, H+1, n), (A, B, H, m)``. K6 and K7 are one function in two TPU lane
layouts, so both launch one kernel here (``csrc/fused_rollout_batched.cu``).
K2 and it run one body (``csrc/rollout_group.cuh``): a group of lanes per
candidate, one warp per trajectory, the trajectory's steps staged in shared
memory; so each batched candidate equals K2's on its trajectory bit for bit.
Each entry point keeps its own launch count.

The TPU kernels trace the user's dynamics into their bodies. A CUDA kernel
cannot, so the kernels carry the plants they know (quadrotor and cart-pole,
``csrc/plants.cuh``) as device functions, and the wrappers read the plant
descriptor of the discrete map (``systems.integrators.DiscreteDynamics``). On
CUDA tensors a plant the kernels do not know raises ``ValueError``; CPU
tensors take the plain forms with the dynamics callable itself. Costs stay
outside, as on the TPU.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops import _build, contract

KERNEL = "fused_rollout_single"
BATCHED_KERNEL = "fused_rollout_batched"  # the source of K6 and K7, and K7's launch count
BATCHED2D_KERNEL = "fused_rollout_batched2d"  # K6's launch count

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def fused_feedback_rollouts_plain(
    dynamics: Dynamics,
    x0: torch.Tensor,
    x_ref_seq: torch.Tensor,
    u_ref_seq: torch.Tensor,
    k_seq: torch.Tensor,
    big_k_seq: torch.Tensor,
    alphas: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K2: all alphas stepped together over the horizon."""
    horizon, m = u_ref_seq.shape
    n_alpha = alphas.shape[0]
    step = vmap(dynamics)
    alpha_col = alphas[:, None].to(x0.dtype)
    x = x0.expand(n_alpha, -1)
    xs, us = [x], []
    for t in range(horizon):
        du = k_seq[t] + (x - x_ref_seq[t]) @ big_k_seq[t].T
        u = u_ref_seq[t] + alpha_col * du
        x = step(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def _launch(dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq, alphas):
    horizon, m = u_ref_seq.shape
    n = x0.shape[0]
    n_alpha = alphas.shape[0]
    plant_id, params, rk4, dt = contract.device_plant(dynamics, KERNEL, n, m)
    dtype = x0.dtype
    inputs = contract.checked(KERNEL, [x0, x_ref_seq[:horizon], u_ref_seq, k_seq, big_k_seq, alphas.to(dtype)],
                     [(n,), (horizon, n), (horizon, m), (horizon, m), (horizon, m, n), (n_alpha,)], dtype, x0.device)
    cand_x = x0.new_empty((n_alpha, horizon + 1, n))
    cand_u = x0.new_empty((n_alpha, horizon, m))

    fn = _build.bind(KERNEL, "qt_fused_rollout", ctypes.c_int,
                     [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_double), ctypes.c_double] + [ctypes.c_void_p] * 9)
    _build.launch(KERNEL, fn, x0.device, contract.DTYPES[dtype], plant_id, horizon, n_alpha, rk4, params, dt,
                  *[t.data_ptr() for t in inputs], cand_x.data_ptr(), cand_u.data_ptr())
    return cand_x, cand_u


def fused_feedback_rollouts(
    dynamics: Dynamics,
    x0: torch.Tensor,  # (n,)
    x_ref_seq: torch.Tensor,  # (H+1, n) (only the first H rows are read)
    u_ref_seq: torch.Tensor,  # (H, m)
    k_seq: torch.Tensor,  # (H, m)
    big_k_seq: torch.Tensor,  # (H, m, n)
    alphas: torch.Tensor,  # (A,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-alpha rollouts: ``(cand_x (A, H+1, n), cand_u (A, H, m))``.

    CUDA tensors launch K2 once; CPU tensors take the plain form.
    """
    return contract.on_device(KERNEL, x0, _launch, fused_feedback_rollouts_plain,
                     dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq, alphas)


def fused_feedback_rollouts_batched_plain(
    dynamics: Dynamics,
    x0: torch.Tensor,
    x_ref_seq: torch.Tensor,
    u_ref_seq: torch.Tensor,
    k_seq: torch.Tensor,
    big_k_seq: torch.Tensor,
    alphas: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K6/K7: K2's plain form over a leading batch axis, transposed to (A, B, ...)."""
    horizon = u_ref_seq.shape[1]
    per_lane = vmap(partial(fused_feedback_rollouts_plain, dynamics), in_dims=(0, 0, 0, 0, 0, None))
    cand_x, cand_u = per_lane(x0, x_ref_seq[:, :horizon], u_ref_seq, k_seq, big_k_seq, alphas)
    return cand_x.transpose(0, 1).contiguous(), cand_u.transpose(0, 1).contiguous()


def _launch_batched(count, dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq, alphas):
    batch, horizon, m = u_ref_seq.shape
    n = x0.shape[-1]
    n_alpha = alphas.shape[0]
    plant_id, params, rk4, dt = contract.device_plant(dynamics, count, n, m)
    dtype = x0.dtype
    ref_rows = x_ref_seq.shape[1] if x_ref_seq.dim() == 3 else -1
    inputs = contract.checked(count, [x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq, alphas.to(dtype)],
                     [(batch, n), (batch, max(ref_rows, horizon), n), (batch, horizon, m), (batch, horizon, m),
                      (batch, horizon, m, n), (n_alpha,)], dtype, x0.device)
    cand_x = x0.new_empty((n_alpha, batch, horizon + 1, n))
    cand_u = x0.new_empty((n_alpha, batch, horizon, m))

    fn = _build.bind(BATCHED_KERNEL, "qt_fused_rollout_batched", ctypes.c_int,
                     [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_double), ctypes.c_double] + [ctypes.c_void_p] * 9)
    _build.launch(count, fn, x0.device, contract.DTYPES[dtype], plant_id, batch, horizon, n_alpha, ref_rows, rk4,
                  params, dt, *[t.data_ptr() for t in inputs], cand_x.data_ptr(), cand_u.data_ptr())
    return cand_x, cand_u


def fused_feedback_rollouts_batched(
    dynamics: Dynamics,
    x0: torch.Tensor,  # (B, n)
    x_ref_seq: torch.Tensor,  # (B, H+1, n) (only the first H rows are read)
    u_ref_seq: torch.Tensor,  # (B, H, m)
    k_seq: torch.Tensor,  # (B, H, m)
    big_k_seq: torch.Tensor,  # (B, H, m, n)
    alphas: torch.Tensor,  # (A,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-alpha rollouts of a trajectory batch: ``(cand_x (A, B, H+1, n), cand_u (A, B, H, m))``.

    CUDA tensors launch the batched rollout kernel once (counted as K7); CPU
    tensors take the plain form. The JAX function's ``interpret``, ``tile_b``
    and ``block_t`` size the TPU's VMEM tiles and change no result; they are
    not carried over.
    """
    return contract.on_device(BATCHED_KERNEL, x0, partial(_launch_batched, BATCHED_KERNEL),
                     fused_feedback_rollouts_batched_plain, dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq,
                     alphas)


def fused_feedback_rollouts_batched2d(
    dynamics: Dynamics,
    x0: torch.Tensor,  # (B, n)
    x_ref_seq: torch.Tensor,  # (B, H+1, n) (only the first H rows are read)
    u_ref_seq: torch.Tensor,  # (B, H, m)
    k_seq: torch.Tensor,  # (B, H, m)
    big_k_seq: torch.Tensor,  # (B, H, m, n)
    alphas: torch.Tensor,  # (A,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as ``fused_feedback_rollouts_batched`` (counted as K6).

    On the TPU it packs the (alpha, batch) pairs onto sublanes and lanes; its
    ``interpret``, ``tile_s``, ``block_t`` and ``max_resident`` size VMEM
    tiles and change no result, and are not carried over. Here it launches
    the same kernel, one group of lanes per (alpha, trajectory) pair.
    """
    return contract.on_device(BATCHED2D_KERNEL, x0, partial(_launch_batched, BATCHED2D_KERNEL),
                     fused_feedback_rollouts_batched_plain, dynamics, x0, x_ref_seq, u_ref_seq, k_seq, big_k_seq,
                     alphas)
