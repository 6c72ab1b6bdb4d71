"""Fused batched linearize + quadratize (kernel K5) and its plain form.

Counterpart of ``quattro_tpu/ops/fused_linquad.py::linquad_batched_fused``:
all stage derivatives (A, B, l_xx, l_uu, l_ux, l_x, l_u) of a (B, H)
trajectory batch in one launch, written straight into the packed stage
layout that the batched backward pass reads
(``riccati_backward_batched_fused2d(packed_stage=...)``, kernel K4): per
tensor ``(nb * h_pad, entries, tile_s, 128)``, the horizon padded to a
multiple of ``block_t`` with identity stages (A = I, B = 0, l_uu = I, the rest
0) prepended in time. The layout is element for element the TPU kernel's, so
the chain K5 -> K4 crosses device memory once with no repack. ``tile_s`` and
``block_t`` define that layout and are kept.

The TPU kernel traces ``jax.jacfwd`` of the user's dynamics and the autodiff
expansion of the user's cost into its body. A CUDA kernel cannot, so
``csrc/fused_linquad.cu`` carries the in-repo plants (``csrc/plants.cuh``,
the step's value once per point, then tangent-only Jacobian columns) and the
quadratic + softplus^2-barrier cost (``csrc/costs.cuh``, analytic expansion)
as device functions; on CUDA tensors other plants or costs raise
``ValueError``. CPU tensors take the
plain form, the port's ``solver/derivatives.py`` over the batch, then packed.
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops import _build, contract
from quattro_tpu_torch.ops.fused_riccati import (
    LANE,
    default_tile_s,
    pack_stages,
    stage_shapes,
    unpack_stage,
)
from quattro_tpu_torch.solver.derivatives import linearize_dynamics, quadratize_cost

KERNEL = "fused_linquad"

__all__ = ["KERNEL", "linquad_batched_fused", "linquad_batched_fused_plain", "unpack_stage"]

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
RunningCost = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _layout(x_seq: torch.Tensor, u_seq: torch.Tensor, tile_s: Optional[int], block_t: int):
    """``(tile_s, h_pad)`` of the packed layout; the misaligned batch raises as in JAX."""
    batch, horizon, _ = u_seq.shape
    if tile_s is None:
        tile_s = default_tile_s(batch)
    if batch % (tile_s * LANE):
        raise ValueError(
            f"linquad_batched_fused needs batch % (tile_s*128) == 0 (got batch={batch}, tile_s={tile_s})"
        )
    if x_seq.dim() != 3 or x_seq.shape[:2] != (batch, horizon + 1):
        raise ValueError(f"linquad_batched_fused: x_seq must be (B, H+1, n) = ({batch}, {horizon + 1}, n), "
                         f"got {tuple(x_seq.shape)}")
    return tile_s, -(-horizon // block_t) * block_t


def linquad_batched_fused_plain(
    dynamics: Dynamics,
    cost: RunningCost,
    x_seq: torch.Tensor,
    u_seq: torch.Tensor,
    tile_s: Optional[int] = None,
    block_t: int = 2,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch form of K5: the solver's derivatives over the batch, pad stages prepended, packed."""
    tile_s, h_pad = _layout(x_seq, u_seq, tile_s, block_t)
    a, b = vmap(partial(linearize_dynamics, dynamics))(x_seq, u_seq)
    l_x, l_u, l_xx, l_uu, l_ux = vmap(partial(quadratize_cost, cost))(x_seq, u_seq)
    return tuple(pack_stages((a, b, l_xx, l_uu, l_ux, l_x, l_u), tile_s, h_pad))


def _launch(dynamics, cost, x_seq, u_seq, tile_s, block_t):
    tile_s, h_pad = _layout(x_seq, u_seq, tile_s, block_t)
    batch, horizon, m = u_seq.shape
    n = x_seq.shape[-1]
    plant_id, params, rk4, dt = contract.device_plant(dynamics, KERNEL, n, m)
    dtype, device = x_seq.dtype, x_seq.device
    data = contract.checked(KERNEL, [x_seq, u_seq], [(batch, horizon + 1, n), (batch, horizon, m)], dtype, device)
    tables, barrier_alpha, barrier_beta = contract.cost_tables(KERNEL, cost, None, n, m, x_seq)
    inputs = data + tables
    chunk = tile_s * LANE
    outputs = [x_seq.new_empty((batch // chunk * h_pad, math.prod(tail), tile_s, LANE))
               for tail in stage_shapes(n, m)]

    fn = _build.bind(KERNEL, "qt_fused_linquad", ctypes.c_int,
                     [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_double)] + [ctypes.c_double] * 3
                     + [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p])
    out_ptrs = (ctypes.c_void_p * len(outputs))(*[t.data_ptr() for t in outputs])
    _build.launch(KERNEL, fn, device, contract.DTYPES[dtype], plant_id, batch, horizon, h_pad, chunk, rk4, params, dt,
                  barrier_alpha, barrier_beta, *[t.data_ptr() for t in inputs], out_ptrs)
    return tuple(outputs)


def linquad_batched_fused(
    dynamics: Dynamics,
    cost: RunningCost,
    x_seq: torch.Tensor,  # (B, H+1, n) (last state unused)
    u_seq: torch.Tensor,  # (B, H, m)
    tile_s: Optional[int] = None,
    block_t: int = 2,
) -> Tuple[torch.Tensor, ...]:
    """All stage derivatives of a trajectory batch, packed: one K5 launch on CUDA.

    Returns the seven packed stage tensors ``(a, b, l_xx, l_uu, l_ux, l_x,
    l_u)``, each ``(nb * h_pad, entries, tile_s, 128)`` with ``h_pad`` the
    horizon rounded up to ``block_t`` (pad steps prepended). Feed them to
    ``riccati_backward_batched_fused2d(packed_stage=...)`` or unpack them with
    ``unpack_stage``. ``tile_s`` defaults to ``min(8, ceil(B / 128))``; the
    batch must be a multiple of ``tile_s * 128`` (``ValueError`` otherwise).
    The JAX function's ``interpret`` is not carried over.

    On CUDA the dynamics must be ``make_discrete`` of a plant the kernel knows
    (``QuadrotorField``, ``CartPoleField``) and the cost one of
    ``make_quadratic_cost``; anything else raises ``ValueError``. CPU tensors
    take the plain form.
    """
    return contract.on_device(KERNEL, x_seq, _launch, linquad_batched_fused_plain,
                              dynamics, cost, x_seq, u_seq, tile_s, block_t)
