"""Single-trajectory fused backward Riccati pass (kernel K1) and its plain form.

Counterpart of ``quattro_tpu/ops/fused_riccati.py::riccati_backward_fused_single``
(step law ``riccati_step_tiles``). On CUDA tensors the whole H-step recursion
runs as one launch of ``csrc/fused_riccati_single.cu``; on CPU tensors the
plain PyTorch form below computes the same function. There is no fallback
from one to the other: a CUDA input the kernel cannot take raises.

Same algebraic form as the TPU kernel: no explicit symmetrization of V_xx,
V_xx' = Q_xx - G'Q_ux - reg G'G, gains k = -g_u, K = -G.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from quattro_tpu_torch.ops import _build

KERNEL = "fused_riccati_single"
MAX_N = 16
MAX_M = 8
_DTYPES = {torch.float32: 0, torch.float64: 1}

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
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"{KERNEL} takes n <= {MAX_N} and m <= {MAX_M}; got n={n}, m={m}")
    dtype = a_seq.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{KERNEL} takes float32 or float64, got {dtype}")
    inputs = [a_seq, b_seq, *cost_exp, v_x_final, v_xx_final]
    shapes = [(horizon, n, n), (horizon, n, m), (horizon, n), (horizon, m), (horizon, n, n),
              (horizon, m, m), (horizon, m, n), (n,), (n, n)]
    for t, shape in zip(inputs, shapes):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != a_seq.device:
            raise ValueError(
                f"{KERNEL}: expected {shape} {dtype} on {a_seq.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    inputs = [t.contiguous() for t in inputs]
    k_seq = a_seq.new_empty((horizon, m))
    big_k_seq = a_seq.new_empty((horizon, m, n))
    v_x_seq = a_seq.new_empty((horizon + 1, n))
    v_xx_seq = a_seq.new_empty((horizon + 1, n, n))
    outputs = [k_seq, big_k_seq, v_x_seq, v_xx_seq]

    lib = _build.library(KERNEL)
    fn = lib.qt_fused_riccati_single
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_double] + [ctypes.c_void_p] * 14
    with torch.cuda.device(a_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            _DTYPES[dtype], horizon, n, m, float(reg),
            *[t.data_ptr() for t in inputs], *[t.data_ptr() for t in outputs], stream,
        )
    _build.check(status, KERNEL)
    _build.launches[KERNEL] += 1
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
    if a_seq.is_cuda:
        return _launch(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg)
    if a_seq.device.type == "cpu":
        return riccati_backward_fused_single_plain(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg)
    raise ValueError(f"{KERNEL}: unsupported device {a_seq.device}")
