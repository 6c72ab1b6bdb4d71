"""Fused backward Riccati passes (kernels K1 and K4) and their plain forms.

Counterparts of ``quattro_tpu/ops/fused_riccati.py``:

- ``riccati_backward_fused_single`` (K1, step law ``riccati_step_tiles``):
  one trajectory, the whole H-step recursion as one launch of
  ``csrc/fused_riccati_single.cu``.
- ``riccati_backward_batched_fused``, ``riccati_backward_batched_fused2d``
  and ``riccati_backward_batched_fused_auto`` (K4): a batch of trajectories,
  one launch of ``csrc/fused_riccati_batched.cu``, whose warp per trajectory
  computes K1's step (``csrc/riccati_warp.cuh``) bit for bit. The TPU's two
  batch layouts (batch on lanes; every matrix entry a (tile_s, 128) tile) are
  one kernel here; the packed layout survives as the ``packed_stage=`` input
  that ``ops/fused_linquad.py`` (K5) writes.

On CUDA tensors the kernels run; on CPU tensors the plain PyTorch forms below
compute the same functions. There is no fallback from one to the other: a
CUDA input a kernel cannot take raises.

Same algebraic form as the TPU kernels: no explicit symmetrization of V_xx,
V_xx' = Q_xx - G'Q_ux - reg G'G, gains k = -g_u, K = -G. (The TPU batch2d
kernel re-symmetrizes its carry, which changes only rounding.)
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
from torch.func import vmap

from quattro_tpu_torch.ops import _build, contract

KERNEL = "fused_riccati_single"
BATCHED_KERNEL = "fused_riccati_batched"
LANE = 128
_STORED_BF16 = 2  # the batched kernel's code for bfloat16 stage inputs

RiccatiOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def riccati_step(a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx, reg: float):
    """One backward step of the fused kernels' law.

    Returns ``(g_u (m,), g_x (m, n), v_x' (n,), v_xx' (n, n))``; gains are
    ``k = -g_u``, ``K = -g_x``.
    """
    m = l_uu.shape[0]
    at, bt = a.T, b.T
    t1 = v_xx @ a
    t3 = v_xx @ b
    q_xx = l_xx + at @ t1
    q_ux = l_ux + bt @ t1
    q_uxt = l_ux.T + at @ t3
    q_uu = l_uu + bt @ t3
    q_x = l_x + v_x @ a
    q_u = l_u + v_x @ b

    # Unrolled Cholesky of Q_uu + reg I with rsqrt, reading the upper triangle.
    chol = [[None] * m for _ in range(m)]
    inv_diag = [None] * m
    for j in range(m):
        diag = q_uu[j, j] + reg
        for s in range(j):
            diag = diag - chol[j][s] * chol[j][s]
        inv = torch.rsqrt(diag)
        chol[j][j] = diag * inv
        inv_diag[j] = inv
        for i in range(j + 1, m):
            off = q_uu[j, i]
            for s in range(j):
                off = off - chol[i][s] * chol[j][s]
            chol[i][j] = off * inv

    rhs = torch.cat([q_u[:, None], q_ux], dim=1)  # (m, 1+n)
    ys = []
    for i in range(m):
        acc = rhs[i]
        for s in range(i):
            acc = acc - chol[i][s] * ys[s]
        ys.append(acc * inv_diag[i])
    xs = [None] * m
    for i in reversed(range(m)):
        acc = ys[i]
        for s in range(i + 1, m):
            acc = acc - chol[s][i] * xs[s]
        xs[i] = acc * inv_diag[i]
    sol = torch.stack(xs)  # (m, 1+n) = [g_u | G]
    g_u, g_x = sol[:, 0], sol[:, 1:]

    v_xx_new = q_xx - g_x.T @ q_ux - reg * (g_x.T @ g_x)
    inner = q_u - q_uu @ g_u
    v_x_new = q_x - g_x.T @ inner - q_uxt @ g_u
    return g_u, g_x, v_x_new, v_xx_new


def riccati_backward_fused_single_plain(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: Sequence[torch.Tensor],  # CostExpansion (l_x, l_u, l_xx, l_uu, l_ux)
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
) -> RiccatiOutputs:
    """Plain PyTorch form of K1: ``riccati_step`` looped over the horizon."""
    horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    k_seq = a_seq.new_empty((horizon, m))
    big_k_seq = a_seq.new_empty((horizon, m, n))
    v_x_seq = a_seq.new_empty((horizon + 1, n))
    v_xx_seq = a_seq.new_empty((horizon + 1, n, n))
    l_x, l_u, l_xx, l_uu, l_ux = cost_exp
    v_x, v_xx = v_x_final, v_xx_final
    v_x_seq[horizon] = v_x
    v_xx_seq[horizon] = v_xx
    for t in reversed(range(horizon)):
        g_u, g_x, v_x, v_xx = riccati_step(
            a_seq[t], b_seq[t], l_x[t], l_u[t], l_xx[t], l_uu[t], l_ux[t], v_x, v_xx, reg
        )
        k_seq[t] = -g_u
        big_k_seq[t] = -g_x
        v_x_seq[t] = v_x
        v_xx_seq[t] = v_xx
    return k_seq, big_k_seq, v_x_seq, v_xx_seq


def _launch(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg) -> RiccatiOutputs:
    horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    if n > contract.MAX_N or m > contract.MAX_M:
        raise ValueError(f"{KERNEL} takes n <= {contract.MAX_N} and m <= {contract.MAX_M}; got n={n}, m={m}")
    dtype = a_seq.dtype
    inputs = contract.checked(KERNEL, [a_seq, b_seq, *cost_exp, v_x_final, v_xx_final],
                     [(horizon, n, n), (horizon, n, m), (horizon, n), (horizon, m), (horizon, n, n),
                      (horizon, m, m), (horizon, m, n), (n,), (n, n)], dtype, a_seq.device)
    k_seq = a_seq.new_empty((horizon, m))
    big_k_seq = a_seq.new_empty((horizon, m, n))
    v_x_seq = a_seq.new_empty((horizon + 1, n))
    v_xx_seq = a_seq.new_empty((horizon + 1, n, n))
    outputs = [k_seq, big_k_seq, v_x_seq, v_xx_seq]

    fn = _build.bind(KERNEL, "qt_fused_riccati_single", ctypes.c_int,
                     [ctypes.c_int] * 4 + [ctypes.c_double] + [ctypes.c_void_p] * 14)
    _build.launch(KERNEL, fn, a_seq.device, contract.DTYPES[dtype], horizon, n, m, float(reg),
                  *[t.data_ptr() for t in inputs], *[t.data_ptr() for t in outputs])
    return k_seq, big_k_seq, v_x_seq, v_xx_seq


def riccati_backward_fused_single(
    a_seq: torch.Tensor,  # (H, n, n)
    b_seq: torch.Tensor,  # (H, n, m)
    cost_exp: Sequence[torch.Tensor],  # CostExpansion fields (H, ...)
    v_x_final: torch.Tensor,  # (n,)
    v_xx_final: torch.Tensor,  # (n, n)
    reg: float = 1e-6,
) -> RiccatiOutputs:
    """Full single-trajectory backward pass: ``(k (H,m), K (H,m,n), V_x (H+1,n), V_xx (H+1,n,n))``.

    CUDA tensors launch K1 once; CPU tensors take the plain form.
    """
    return contract.on_device(KERNEL, a_seq, _launch, riccati_backward_fused_single_plain,
                     a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg)


# ---------------------------------------------------------------------------
# Batched backward pass (K4)
# ---------------------------------------------------------------------------

# Stage tensors in the packed order of the TPU kernels (and of K5's output).
STAGE_NAMES = ("a", "b", "l_xx", "l_uu", "l_ux", "l_x", "l_u")


def stage_shapes(n: int, m: int):
    """Trailing shape of each stage tensor, in ``STAGE_NAMES`` order."""
    return ((n, n), (n, m), (n, n), (m, m), (m, n), (n,), (m,))


def default_tile_s(batch: int) -> int:
    """The TPU kernels' default ``tile_s``: ``min(8, ceil(batch / 128))``, at least 1."""
    return max(1, min(8, -(-batch // LANE)))


def pack_stage(x: torch.Tensor, tile_s: int) -> torch.Tensor:
    """(B, h_pad, *tail) -> (nb * h_pad, entries, tile_s, 128), the packed stage layout.

    Axis 0 is batch block then time, axis 1 the row-major matrix entry, the
    last two the in-block trajectory ``b = blk * tile_s * 128 + s * 128 + l``.
    """
    batch, h_pad = x.shape[:2]
    entries = math.prod(x.shape[2:])
    nb = batch // (tile_s * LANE)
    xr = x.reshape(nb, tile_s, LANE, h_pad, entries)
    return xr.permute(0, 3, 4, 1, 2).reshape(nb * h_pad, entries, tile_s, LANE)


def pack_stages(stages: Sequence[torch.Tensor], tile_s: int, h_pad: int):
    """The seven natural stage tensors (B, H, ...), ``STAGE_NAMES`` order, packed for K4.

    The horizon is padded to ``h_pad`` with identity stages prepended in time
    (A = I, B = 0, l_uu = I, the rest 0), which leave the backward recursion's
    carry unchanged.
    """
    n, m = stages[1].shape[-2:]
    packed = []
    for x, eye in zip(stages, (n, None, None, m, None, None, None)):
        pad = x.new_zeros((x.shape[0], h_pad - x.shape[1]) + tuple(x.shape[2:]))
        if eye is not None:
            pad[:] = torch.eye(eye, dtype=x.dtype, device=x.device)
        packed.append(pack_stage(torch.cat([pad, x], dim=1), tile_s))
    return packed


def unpack_stage(x: torch.Tensor, batch: int, horizon: int, shape_tail: tuple, tile_s: int) -> torch.Tensor:
    """Packed (nb * h_pad, e, tile_s, 128) -> (B, H, *shape_tail), dropping the prepended pad steps."""
    entries = x.shape[1]
    nb = batch // (tile_s * LANE)
    h_pad = x.shape[0] // nb
    xr = x.reshape(nb, h_pad, entries, tile_s, LANE)
    out = xr.permute(0, 3, 4, 1, 2).reshape(batch, h_pad, entries)
    return out[:, h_pad - horizon:].reshape((batch, horizon) + tuple(shape_tail))


def _stream_code(stream_dtype, dtype) -> int:
    if stream_dtype is None or stream_dtype == dtype:
        return 0
    if stream_dtype == torch.bfloat16:
        return _STORED_BF16
    raise TypeError(f"{BATCHED_KERNEL} streams stage inputs in bfloat16 or in the carry dtype, got {stream_dtype}")


def _round_stages(stages, stream_dtype):
    """The plain form's stream: stage inputs rounded through ``stream_dtype`` (round to nearest even)."""
    if _stream_code(stream_dtype, stages[0].dtype) == 0:
        return stages
    return [x.to(stream_dtype).to(x.dtype) for x in stages]


def riccati_backward_batched_fused_plain(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: Sequence[torch.Tensor],
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    stream_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K4: K1's ``riccati_step`` over a leading batch axis.

    With ``stream_dtype=torch.bfloat16`` the stage inputs are rounded through
    bfloat16 first, as the kernel stores them; the carry, the arithmetic and
    the gains stay in the input dtype.
    """
    batch, horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    l_x, l_u, l_xx, l_uu, l_ux = cost_exp
    a, b, l_xx, l_uu, l_ux, l_x, l_u = _round_stages([a_seq, b_seq, l_xx, l_uu, l_ux, l_x, l_u], stream_dtype)
    step = vmap(riccati_step, in_dims=(0,) * 9 + (None,))
    k_seq = a_seq.new_empty((batch, horizon, m))
    big_k_seq = a_seq.new_empty((batch, horizon, m, n))
    v_x, v_xx = v_x_final, v_xx_final
    for t in reversed(range(horizon)):
        g_u, g_x, v_x, v_xx = step(a[:, t], b[:, t], l_x[:, t], l_u[:, t], l_xx[:, t], l_uu[:, t], l_ux[:, t],
                                   v_x, v_xx, reg)
        k_seq[:, t] = -g_u
        big_k_seq[:, t] = -g_x
    return k_seq, big_k_seq


def _launch_batched(stages, v_x_final, v_xx_final, reg, stream_dtype, horizon, packed=None):
    """One K4 launch. ``stages`` in ``STAGE_NAMES`` order, natural (B, H, ...) or,
    with ``packed=(tile_s, h_pad)``, in the packed layout."""
    batch, n = v_x_final.shape
    m = stages[6].shape[1 if packed else -1]  # l_u: (nb * h_pad, m, tile_s, 128) or (B, H, m)
    dtype, device = v_x_final.dtype, v_x_final.device
    if n > contract.MAX_N or m > contract.MAX_M:
        raise ValueError(f"{BATCHED_KERNEL} takes n <= {contract.MAX_N} and m <= {contract.MAX_M}; got n={n}, m={m}")
    stored = _stream_code(stream_dtype, dtype)
    tails = stage_shapes(n, m)
    if packed is None:
        shapes = [(batch, horizon) + tail for tail in tails]
        chunk, h_pad = 0, 0
    else:
        tile_s, h_pad = packed
        chunk = tile_s * LANE
        shapes = [(batch // chunk * h_pad, math.prod(tail), tile_s, LANE) for tail in tails]
    *stages, v_x_final, v_xx_final = contract.checked(BATCHED_KERNEL, [*stages, v_x_final, v_xx_final],
                                             shapes + [(batch, n), (batch, n, n)], dtype, device,
                                             STAGE_NAMES + ("v_x_final", "v_xx_final"))
    if stored:
        stages = [t.to(stream_dtype) for t in stages]
    k_seq = v_x_final.new_empty((batch, horizon, m))
    big_k_seq = v_x_final.new_empty((batch, horizon, m, n))

    fn = _build.bind(BATCHED_KERNEL, "qt_fused_riccati_batched", ctypes.c_int,
                     [ctypes.c_int] * 9 + [ctypes.c_double, ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 5)
    stage_ptrs = (ctypes.c_void_p * len(stages))(*[t.data_ptr() for t in stages])
    _build.launch(BATCHED_KERNEL, fn, device, contract.DTYPES[dtype], stored, int(packed is not None), batch, horizon,
                  n, m, chunk, h_pad, float(reg), stage_ptrs, v_x_final.data_ptr(), v_xx_final.data_ptr(),
                  k_seq.data_ptr(), big_k_seq.data_ptr())
    return k_seq, big_k_seq


def _launch_natural(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, stream_dtype):
    l_x, l_u, l_xx, l_uu, l_ux = cost_exp
    return _launch_batched([a_seq, b_seq, l_xx, l_uu, l_ux, l_x, l_u], v_x_final, v_xx_final, reg, stream_dtype,
                           a_seq.shape[1])


def _batched(a_seq, *rest):
    return contract.on_device(BATCHED_KERNEL, a_seq, _launch_natural, riccati_backward_batched_fused_plain,
                              a_seq, *rest)


def riccati_backward_batched_fused(
    a_seq: torch.Tensor,  # (B, H, n, n)
    b_seq: torch.Tensor,  # (B, H, n, m)
    cost_exp: Sequence[torch.Tensor],  # CostExpansion fields (B, H, ...)
    v_x_final: torch.Tensor,  # (B, n)
    v_xx_final: torch.Tensor,  # (B, n, n)
    reg: float = 1e-6,
    stream_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched backward pass: ``(k (B, H, m), K (B, H, m, n))``.

    CUDA tensors launch K4 once; CPU tensors take the plain form.
    ``stream_dtype=torch.bfloat16`` stores the stage inputs (A, B, the cost
    expansion) in bfloat16, widened at load; the carry, the arithmetic and the
    gains stay in ``a_seq.dtype`` (about 1e-3 relative error on the gains).

    The JAX function's ``interpret``, ``tile_b`` and ``block_t`` are not
    carried over: they select Pallas's interpreter and size the TPU's VMEM
    tiles, and change no result. The kernel reads the natural layout, so no
    batch or horizon padding is needed.
    """
    return _batched(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, stream_dtype)


def riccati_backward_batched_fused2d(
    a_seq: Optional[torch.Tensor],  # (B, H, n, n), or None with packed_stage
    b_seq: Optional[torch.Tensor],  # (B, H, n, m)
    cost_exp: Optional[Sequence[torch.Tensor]],
    v_x_final: torch.Tensor,  # (B, n)
    v_xx_final: torch.Tensor,  # (B, n, n)
    reg: float = 1e-6,
    tile_s: Optional[int] = None,
    block_t: int = 2,
    stream_dtype=None,
    packed_stage: Optional[Sequence[torch.Tensor]] = None,
    horizon: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched backward pass, also from the packed stage layout.

    Without ``packed_stage`` it computes what ``riccati_backward_batched_fused``
    computes (one K4 launch on CUDA); ``tile_s`` and ``block_t`` then change
    nothing. ``packed_stage``: the seven stage tensors ``(a, b, l_xx, l_uu,
    l_ux, l_x, l_u)``, each ``(nb * h_pad, entries, tile_s, 128)`` with the
    horizon pre-padded, as ``ops/fused_linquad.py::linquad_batched_fused``
    writes them; ``a_seq``/``b_seq``/``cost_exp`` may be None, ``horizon``
    (the unpadded horizon) is required and the batch (from ``v_x_final``) must
    be a multiple of ``tile_s * 128``. K4 reads that layout in place; the plain
    form (CPU) unpacks it first.

    The JAX function's ``interpret`` is not carried over. Returns
    ``(k (B, H, m), K (B, H, m, n))``.
    """
    if packed_stage is None:
        return _batched(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, stream_dtype)
    batch, n = v_x_final.shape
    if tile_s is None:
        tile_s = default_tile_s(batch)
    chunk = tile_s * LANE
    if batch % chunk:
        raise ValueError(
            f"packed_stage path needs batch % (tile_s*128) == 0 (got batch={batch}, tile_s={tile_s})"
        )
    if horizon is None:
        raise ValueError("packed_stage path needs the unpadded horizon")
    h_pad = packed_stage[0].shape[0] // (batch // chunk)
    if h_pad % block_t:
        raise ValueError(f"packed h_pad {h_pad} must be divisible by block_t {block_t}")
    if h_pad < horizon:
        raise ValueError(f"packed h_pad {h_pad} is shorter than the horizon {horizon}")

    def plain():
        m = packed_stage[6].shape[1]
        a, b, l_xx, l_uu, l_ux, l_x, l_u = (
            unpack_stage(x, batch, horizon, tail, tile_s) for x, tail in zip(packed_stage, stage_shapes(n, m))
        )
        return riccati_backward_batched_fused_plain(a, b, (l_x, l_u, l_xx, l_uu, l_ux), v_x_final, v_xx_final, reg,
                                                    stream_dtype)

    return contract.on_device(BATCHED_KERNEL, v_x_final, lambda: _launch_batched(
        list(packed_stage), v_x_final, v_xx_final, reg, stream_dtype, horizon, packed=(tile_s, h_pad)), plain)


def riccati_backward_batched_fused_auto(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: Sequence[torch.Tensor],
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    stream_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched backward pass for any batch width: one K4 launch on CUDA.

    The JAX dispatcher picks its batch2d kernel from B >= 1024 (with little
    padding) and its column-major kernel below: two TPU layouts of one
    function, whose speeds cross over on the TPU. On this card one kernel
    serves every width, so there is no threshold to carry over.
    """
    return _batched(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, stream_dtype)
