"""Riccati backward passes (counterpart of ``quattro_tpu/solver/riccati.py``).

- ``riccati_backward``: the sequential recursion with the reference update
  law (Tikhonov ``reg`` on Q_uu in the solve only, value update with raw
  Q_uu, V_xx symmetrized); ``riccati_backward_segment`` runs it over the last
  ``window`` steps.
- ``riccati_backward_associative``: the associative-scan form. The backward
  recursion is the composition of affine value-function maps, which is
  associative: each stage becomes a 5-tuple element (A, b, C, eta, J) as in
  Särkkä & García-Fernández, "Temporal Parallelization of Dynamic
  Programming" (arXiv:1905.13002), composed by ``_combine`` in a scan of
  O(log H) depth. Cross terms (l_ux) and the linear control cost (l_u) are
  pre-eliminated exactly (``_stage_elements``); reg sits on l_uu here, not on
  Q_uu. Written over any leading batch axes: the stage elements' SPD solve
  and the gain extraction's SPD solve are each ONE launch of kernel K8
  (``ops/smallchol.py::batched_cholesky_solve_fused``) over every
  (batch, horizon) system on CUDA, its plain form on the CPU.
- ``riccati_backward_fused``: the single-trajectory fused pass, kernel K1 on
  CUDA (``ops/fused_riccati.py``).
- ``riccati_backward_auto``: the dispatch (see its docstring).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import torch

from quattro_tpu_torch.ops.contract import MAX_M, MAX_N
from quattro_tpu_torch.ops.fused_riccati import riccati_backward_fused_single
from quattro_tpu_torch.ops.smallchol import SMALL_DIM_MAX, batched_cholesky_solve_fused, batched_spd_solve
from quattro_tpu_torch.ops.smalllu import lu_solve, unrolled_lu
from quattro_tpu_torch.solver.derivatives import CostExpansion

Reg = Union[float, torch.Tensor]  # a float, or one value per trajectory of the leading batch axes


class RiccatiResult(NamedTuple):
    k_seq: torch.Tensor  # (H, m) feedforward
    big_k_seq: torch.Tensor  # (H, m, n) feedback gains
    v_x_seq: torch.Tensor  # (H+1, n) value gradients, v_x_seq[t] = V_x at step t
    v_xx_seq: torch.Tensor  # (H+1, n, n) value Hessians


def _tr(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _mv(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", mat, vec)


def _reg_eye(reg: Reg, m: int, like: torch.Tensor) -> torch.Tensor:
    """``reg * I_m``; a tensor reg (one value per trajectory) broadcasts over (horizon, m, m)."""
    eye = torch.eye(m, dtype=like.dtype, device=like.device)
    if isinstance(reg, torch.Tensor):
        return reg.to(like.dtype)[..., None, None, None] * eye
    return reg * eye


def _spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``batched_spd_solve`` over all leading axes at once: one K8 launch on CUDA for m <= 8.

    Larger m takes ``torch.linalg.solve``, as JAX's ``batched_spd_solve``
    takes ``jnp.linalg.solve`` there.
    """
    m, r = b.shape[-2:]
    if m > SMALL_DIM_MAX:
        return torch.linalg.solve(a, b)
    lead = b.shape[:-2]
    x = batched_cholesky_solve_fused(a.expand(lead + (m, m)).reshape(-1, m, m), b.reshape(-1, m, r))
    return x.reshape(lead + (m, r))


def _q_expansion(a, b, l_x, l_u, l_xx, l_uu, l_ux, v_x, v_xx):
    """One-step Q expansion."""
    q_x = l_x + a.T @ v_x
    q_u = l_u + b.T @ v_x
    q_xx = l_xx + a.T @ v_xx @ a
    q_ux = l_ux + b.T @ v_xx @ a
    q_uu = l_uu + b.T @ v_xx @ b
    return q_x, q_u, q_xx, q_ux, q_uu


def _gains_and_value(q_x, q_u, q_xx, q_ux, q_uu, reg, use_chol: bool = True):
    """Gains from regularized Q_uu; value update with unregularized Q_uu, symmetrized."""
    m = q_uu.shape[0]
    q_uu_reg = q_uu + reg * torch.eye(m, dtype=q_uu.dtype, device=q_uu.device)
    rhs = torch.cat([q_u[:, None], q_ux], dim=1)  # (m, 1+n)
    solve = batched_spd_solve if use_chol else torch.linalg.solve
    sol = -solve(q_uu_reg, rhs)
    k = sol[:, 0]
    big_k = sol[:, 1:]

    v_x = q_x + big_k.T @ q_uu @ k + big_k.T @ q_u + q_ux.T @ k
    v_xx = q_xx + big_k.T @ q_uu @ big_k + big_k.T @ q_ux + q_ux.T @ big_k
    v_xx = 0.5 * (v_xx + v_xx.T)
    return k, big_k, v_x, v_xx


def riccati_backward(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Sequential backward Riccati over the full horizon (a Python loop over H)."""
    horizon, n, _ = a_seq.shape
    m = b_seq.shape[-1]
    k_seq = a_seq.new_empty((horizon, m))
    big_k_seq = a_seq.new_empty((horizon, m, n))
    v_x_seq = a_seq.new_empty((horizon + 1, n))
    v_xx_seq = a_seq.new_empty((horizon + 1, n, n))
    v_x, v_xx = v_x_final, v_xx_final
    v_x_seq[horizon] = v_x
    v_xx_seq[horizon] = v_xx
    for t in reversed(range(horizon)):
        q = _q_expansion(
            a_seq[t], b_seq[t], cost_exp.l_x[t], cost_exp.l_u[t], cost_exp.l_xx[t],
            cost_exp.l_uu[t], cost_exp.l_ux[t], v_x, v_xx,
        )
        k, big_k, v_x, v_xx = _gains_and_value(*q, reg, use_chol)
        k_seq[t], big_k_seq[t], v_x_seq[t], v_xx_seq[t] = k, big_k, v_x, v_xx
    return RiccatiResult(k_seq, big_k_seq, v_x_seq, v_xx_seq)


def riccati_backward_segment(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    window: int,
    reg: float = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Backward Riccati over only the LAST ``window`` steps of the horizon.

    The exact tail used as the transformer prompt, seeded from the terminal
    cost (the segment ends at the terminal state).
    """
    sl = slice(-window, None)
    tail_exp = CostExpansion(*(e[sl] for e in cost_exp))
    return riccati_backward(a_seq[sl], b_seq[sl], tail_exp, v_x_final, v_xx_final, reg, use_chol)


# ---------------------------------------------------------------------------
# Associative-scan Riccati
# ---------------------------------------------------------------------------


class ValueElement(NamedTuple):
    """Conditional value-function element V_{t->s}(x_t, x_s).

    ``V(x, z) = 0.5 (z - A x - b)' C^+ (z - A x - b) - eta' x + 0.5 x' J x``;
    composition of two adjacent elements is associative and never inverts C.
    Fields carry any leading axes (batch, horizon) when stacked.
    """

    a: torch.Tensor  # (n, n)
    b: torch.Tensor  # (n,)
    c: torch.Tensor  # (n, n) control-induced covariance B R^{-1} B'
    eta: torch.Tensor  # (n,)
    j: torch.Tensor  # (n, n)


def _combine(earlier: ValueElement, later: ValueElement) -> ValueElement:
    """Compose the element over [t, s) with the element over [s, r) into the element over [t, r).

    Batched over any leading axes. Both inverses it needs, (I + C1 J2)^{-1}
    and its transpose (I + J2 C1)^{-1} (equal by the symmetry of C and J),
    come from ONE unrolled no-pivot LU factorization (``ops/smalllu.py``),
    as in JAX.
    """
    a1, b1, c1, eta1, j1 = earlier
    a2, b2, c2, eta2, j2 = later
    n = a1.shape[-1]
    eye = torch.eye(n, dtype=a1.dtype, device=a1.device)

    lhs = eye + c1 @ j2  # (I + C1 J2)
    factors = unrolled_lu(lhs)

    # (I + C1 J2)^{-1} [...]: columns = [A1 | (b1 + C1 eta2) | C1].
    rhs = torch.cat([a1, (b1 + _mv(c1, eta2))[..., None], c1], dim=-1)
    sol = lu_solve(factors, rhs, transpose=False)
    m_a1 = sol[..., :n]
    m_bc = sol[..., n]
    m_c1 = sol[..., n + 1 :]

    # (I + J2 C1)^{-1} [...] = solve(lhs^T, [...]): columns = [(eta2 - J2 b1) | J2 A1].
    rhs_t = torch.cat([(eta2 - _mv(j2, b1))[..., None], j2 @ a1], dim=-1)
    sol_t = lu_solve(factors, rhs_t, transpose=True)
    mt_eta = sol_t[..., 0]
    mt_j_a1 = sol_t[..., 1:]

    return ValueElement(
        a=a2 @ m_a1,
        b=_mv(a2, m_bc) + b2,
        c=a2 @ m_c1 @ _tr(a2) + c2,
        eta=_mv(_tr(a1), mt_eta) + eta1,
        j=_tr(a1) @ mt_j_a1 + j1,
    )


def _stage_elements_with_factors(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    reg: Reg,
) -> Tuple[ValueElement, torch.Tensor, torch.Tensor]:
    """``_stage_elements`` plus the low-rank factor of each stage's C.

    Every stage's control-induced covariance is rank m: ``C = B W B'`` with
    ``W = (l_uu + reg I)^{-1}``. Returns ``(elements, b_seq, P)`` with
    ``P = W B'`` (..., m, n), so that ``C = b_seq @ P``: the factor the
    Woodbury-structured fold (``_combine_stage_acc``) needs. The SPD solve of
    every stage is one K8 launch on CUDA (r = 1 + 2n).
    """
    l_x, l_u, l_xx, l_uu, l_ux = cost_exp
    m, n = l_ux.shape[-2:]
    l_uu_reg = l_uu + _reg_eye(reg, m, l_uu)
    # Solve l_uu^{-1} [l_u | l_ux | B'] in one factorization (SPD, m small).
    rhs = torch.cat([l_u[..., None], l_ux, _tr(b_seq)], dim=-1)  # (..., m, 1+n+n)
    sol = _spd_solve(l_uu_reg, rhs)
    luu_inv_lu = sol[..., 0]
    luu_inv_lux = sol[..., 1 : 1 + n]
    luu_inv_bt = sol[..., 1 + n :]
    elem = ValueElement(
        a=a_seq - b_seq @ luu_inv_lux,
        b=-_mv(b_seq, luu_inv_lu),
        c=b_seq @ luu_inv_bt,
        eta=-(l_x - _mv(_tr(l_ux), luu_inv_lu)),
        j=l_xx - _tr(l_ux) @ luu_inv_lux,
    )
    return elem, b_seq, luu_inv_bt


def _stage_elements(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    reg: Reg,
) -> ValueElement:
    """Per-stage value elements, with the cross terms and linear control cost eliminated exactly.

    With stage cost ``l_x'dx + l_u'du + .5 dx'l_xx dx + .5 du'l_uu du +
    du'l_ux dx`` and dynamics ``dx+ = A dx + B du``, substituting
    ``du = dw - l_uu^{-1}(l_ux dx + l_u)`` gives an equivalent LQT stage with

        A~   = A - B l_uu^{-1} l_ux
        b~   = -B l_uu^{-1} l_u
        C~   = B l_uu^{-1} B'
        eta~ = -(l_x - l_ux' l_uu^{-1} l_u)
        J~   = l_xx - l_ux' l_uu^{-1} l_ux

    (the element's value carries ``-eta'x + .5 x'J x``). l_uu is regularized
    here, Q_uu in the sequential form.
    """
    return _stage_elements_with_factors(a_seq, b_seq, cost_exp, reg)[0]


def _combine_stage_acc(
    stage: ValueElement,
    b_mat: torch.Tensor,  # (..., n, m): the stage's dynamics B
    p_mat: torch.Tensor,  # (..., m, n): W B' with W = (l_uu + reg I)^{-1}
    acc: ValueElement,
) -> ValueElement:
    """``_combine(stage, acc)`` exploiting the stage's rank-m C = B P.

    The generic combine's two n x n no-pivot LU solves become ONE m x m
    factorization via Woodbury: with ``lhs = I + C1 J2 = I + B P J2``,

        lhs^{-1} X   = X - B S^{-1} P J2 X,      S = I_m + P J2 B
        lhs^{-T} v   = v - (J2 B) S^{-1} P v
        lhs^{-1} C1  = B S^{-1} P                (since P J2 B = S - I)

    Exact algebra: equal to ``_combine`` up to rounding.
    """
    a1, b1, _, eta1, j1 = stage
    a2, b2, c2, eta2, j2 = acc
    m = p_mat.shape[-2]
    eye_m = torch.eye(m, dtype=a1.dtype, device=a1.device)

    y = j2 @ b_mat  # (n, m)
    s = eye_m + p_mat @ y  # (m, m)
    sf = unrolled_lu(s)
    j2a1 = j2 @ a1  # (n, n)
    z = lu_solve(sf, p_mat @ j2a1, transpose=False)  # (m, n)
    m_a1 = a1 - b_mat @ z
    mt_j_a1 = j2a1 - y @ z

    v_bc = b1 + _mv(b_mat, _mv(p_mat, eta2))  # b1 + C1 eta2
    m_bc = v_bc - _mv(b_mat, lu_solve(sf, (p_mat @ _mv(j2, v_bc)[..., None]), transpose=False)[..., 0])
    v2 = eta2 - _mv(j2, b1)
    mt_eta = v2 - _mv(y, lu_solve(sf, _mv(p_mat, v2)[..., None], transpose=False)[..., 0])

    u = a2 @ b_mat  # (n, m)
    vt = p_mat @ _tr(a2)  # (m, n)
    return ValueElement(
        a=a2 @ m_a1,
        b=_mv(a2, m_bc) + b2,
        c=u @ lu_solve(sf, vt, transpose=False) + c2,
        eta=_mv(_tr(a1), mt_eta) + eta1,
        j=_tr(a1) @ mt_j_a1 + j1,
    )


def _terminal_element(v_x_final: torch.Tensor, v_xx_final: torch.Tensor) -> ValueElement:
    zeros = torch.zeros_like(v_xx_final)
    return ValueElement(a=zeros, b=torch.zeros_like(v_x_final), c=zeros, eta=-v_x_final, j=v_xx_final)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Entries of ``even`` at even positions of axis 0, of ``odd`` at odd ones (len(even) - len(odd) is 0 or 1)."""
    pairs = torch.stack([even[: odd.shape[0]], odd], dim=1).reshape((-1,) + tuple(odd.shape[1:]))
    return torch.cat([pairs, even[odd.shape[0]:]], dim=0)


def associative_scan(fn: Callable, elems: NamedTuple, reverse: bool = False) -> NamedTuple:
    """Inclusive scan of ``fn`` along axis 0 of every field, the odd/even recursion of ``jax.lax.associative_scan``.

    The same pairing tree as JAX's: combine adjacent pairs, scan the half-length
    result recursively (the odd outputs), combine each odd output with the next
    element (the even outputs), interleave. With ``reverse=True`` the elements
    are flipped first and the result flipped back, so ``fn`` receives
    (later, earlier) operands, as JAX's does.
    """
    cls = type(elems)

    def fields(x, index):
        return cls(*(f[index] for f in x))

    def scan(xs):
        num = xs[0].shape[0]
        if num < 2:
            return xs
        odd = scan(fn(fields(xs, slice(0, -1, 2)), fields(xs, slice(1, None, 2))))
        nxt = fields(xs, slice(2, None, 2))
        if nxt[0].shape[0] == 0:  # num == 2: nothing to combine
            even = nxt
        elif num % 2 == 0:
            even = fn(fields(odd, slice(0, -1)), nxt)
        else:
            even = fn(odd, nxt)
        even = [torch.cat([x[:1], e], dim=0) for x, e in zip(xs, even)]
        return cls(*(_interleave(e, o) for e, o in zip(even, odd)))

    if reverse:
        elems = cls(*(f.flip(0) for f in elems))
    out = scan(elems)
    if reverse:
        out = cls(*(f.flip(0) for f in out))
    return out


def suffix_value_functions(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: Reg = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All value functions (V_x[t], V_xx[t]) for t = 0..H via the associative scan.

    Any leading batch axes: a_seq (..., H, n, n), v_x_final (..., n). Returns
    (..., H+1, n) and (..., H+1, n, n). O(log H) depth; each combine is a
    batch of elementwise and small-matrix operations over the horizon.
    """
    axis = v_x_final.dim() - 1  # the horizon axis of the stacked elements
    stage = _stage_elements(a_seq, b_seq, cost_exp, reg)
    term = _terminal_element(v_x_final, v_xx_final)
    elems = ValueElement(*(torch.cat([s, t.unsqueeze(axis)], dim=axis).movedim(axis, 0)
                           for s, t in zip(stage, term)))

    # Suffix-inclusive scan: result[t] = elem[t] (.) elem[t+1] (.) ... (.) elem[H]
    # with (.) = _combine(earlier, later). The reversed scan hands its operator
    # (later-in-time, earlier-in-time) operands: swap them back.
    suffix = associative_scan(lambda x, y: _combine(y, x), elems, reverse=True)
    return -suffix.eta.movedim(0, axis), suffix.j.movedim(0, axis)


def riccati_backward_associative(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: Reg = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Parallel (associative-scan) backward Riccati, over any leading batch axes.

    Equal to ``riccati_backward`` up to the placement of reg (on l_uu here).
    Once all suffix value functions are known the gains are independent per
    step: the Q-expansion is batched tensor code over (..., H), and the
    gain solve is one K8 launch over every system on CUDA (one
    ``torch.linalg.solve`` with ``use_chol=False``). ``reg`` may be a tensor
    of one value per trajectory of the leading axes (the batched solve's
    adaptive mu-schedule).
    """
    v_x_seq, v_xx_seq = suffix_value_functions(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg)
    k_seq, big_k_seq = _gains(a_seq, b_seq, cost_exp, v_x_seq[..., 1:, :], v_xx_seq[..., 1:, :, :], reg, use_chol)
    return RiccatiResult(k_seq, big_k_seq, v_x_seq, v_xx_seq)


def _gains(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_next: torch.Tensor,
    v_xx_next: torch.Tensor,
    reg: Reg,
    use_chol: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k, K)`` of every stage from the value function one step later, over any leading axes.

    The Q expansion as batched tensor code and one SPD solve of
    ``Q_uu + reg I`` against ``[Q_u | Q_ux]`` over all systems: one K8 launch
    on CUDA (``torch.linalg.solve`` with ``use_chol=False``).
    """
    _, l_u, _, l_uu, l_ux = cost_exp
    m = l_uu.shape[-1]
    b_t = _tr(b_seq)
    q_u = l_u + _mv(b_t, v_x_next)
    q_ux = l_ux + b_t @ v_xx_next @ a_seq
    q_uu = l_uu + b_t @ v_xx_next @ b_seq
    rhs = torch.cat([q_u[..., None], q_ux], dim=-1)  # (..., H, m, 1+n)
    q_uu_reg = q_uu + _reg_eye(reg, m, q_uu)
    sol = -(_spd_solve(q_uu_reg, rhs) if use_chol else torch.linalg.solve(q_uu_reg, rhs))
    return sol[..., 0], sol[..., 1:]


def riccati_backward_fused(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
) -> RiccatiResult:
    """Single-trajectory fused backward pass: kernel K1 on CUDA, its plain form on the CPU.

    ``use_chol`` is accepted for signature parity; the fused form always uses
    the unrolled Cholesky. ``reg`` is a kernel argument, not a compiled constant.
    """
    return RiccatiResult(
        *riccati_backward_fused_single(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, float(reg))
    )


def auto_form(horizon: int, n: int, m: int, is_cuda: bool, batch_size: int = 1,
              latency_crossover_h: int = 16) -> str:
    """The form ``riccati_backward_auto`` takes: ``"fused"``, ``"assoc"`` or ``"seq"``.

    JAX's rule (the associative form for one trajectory at
    ``horizon >= latency_crossover_h``, the sequential form otherwise), except
    that a single trajectory on the card takes K1 wherever K1 takes the shape.
    """
    if is_cuda and batch_size == 1 and n <= MAX_N and m <= MAX_M:
        return "fused"
    if batch_size == 1 and horizon >= latency_crossover_h:
        return "assoc"
    return "seq"


def riccati_backward_auto(
    a_seq: torch.Tensor,
    b_seq: torch.Tensor,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    use_chol: bool = True,
    batch_size: int = 1,
    latency_crossover_h: int = 16,
) -> RiccatiResult:
    """Pick the backward-pass form for the device and the workload shape.

    On CPU tensors this is JAX's branch: the associative form for a single
    trajectory (``batch_size == 1``) at ``H >= latency_crossover_h``, the
    sequential form otherwise, so a default-configured solve computes what the
    JAX default computes. On the card a single trajectory takes K1 wherever
    the kernel takes the shape (n <= 16, m <= 8): one launch for the whole
    horizon. The card's own numbers (``chip_smoke.py``'s associative phase,
    float32, the bench problem's stages at H = 50 and 100 and the suite's
    random LQ problem at H = 1024, one NVIDIA H100 80GB HBM3 at 700 W;
    ``PERF.md``) put K1 at 0.32 / 0.60 / 5.8 ms against 151 / 204 / 298 ms
    for the associative form (a few thousand small launches per pass, bound
    by the host) and 114 / 336 / 3,396 ms for the sequential form: no
    horizon favours another form on the card.
    Batched callers and larger shapes take JAX's branch.
    """
    horizon, n = a_seq.shape[-3], a_seq.shape[-1]
    form = auto_form(horizon, n, b_seq.shape[-1], a_seq.is_cuda, batch_size, latency_crossover_h)
    backward = {"fused": riccati_backward_fused, "assoc": riccati_backward_associative,
                "seq": riccati_backward}[form]
    return backward(a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, use_chol)
