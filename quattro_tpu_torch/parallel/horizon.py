"""Horizon-partitioned Riccati over a device mesh (counterpart of ``quattro_tpu/parallel/horizon.py``).

The horizon H is cut into one block per shard of the mesh's ``horizon``
axis, and the backward pass runs in three phases (the boundary
value-function halo exchange):

1. each shard condenses its block of stage elements to ONE block element
   (``_local_block_element``, a sequential fold of the Woodbury-structured
   ``_combine_stage_acc``); the stage elements are one launch of kernel K8
   (``ops/smallchol.py``) per shard on CUDA;
2. the block elements are combined across shards: an exclusive suffix scan
   whose hops carry the boundary value function in element form (3n^2 + 2n
   scalars), on the ``"tree"`` (recursive doubling) or ``"ring"`` schedule;
3. each shard reads its right-edge (V_x, V_xx) off the element it received
   and runs the plain sequential block Riccati: one launch of kernel K1
   (``riccati_backward_fused``) per shard on CUDA where K1 takes the shape
   (n <= 16, m <= 8), ``riccati_backward`` elsewhere (as JAX does).

There is no ``shard_map``: each function splits its inputs over the mesh
(``parallel/mesh.py``), runs the local phases shard after shard, and runs the
exchange as explicit ``ppermute`` rounds (``parallel/collectives.py``), in
this process or, on a mesh that spans processes, through
``torch.distributed``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from quattro_tpu_torch.ops.contract import MAX_M, MAX_N
from quattro_tpu_torch.parallel.collectives import AxisComm
from quattro_tpu_torch.parallel.mesh import Coord, GlobalArray, Mesh, assemble, shard
from quattro_tpu_torch.solver.derivatives import CostExpansion
from quattro_tpu_torch.solver.riccati import (
    RiccatiResult,
    ValueElement,
    _combine,
    _combine_stage_acc,
    _stage_elements_with_factors,
    _terminal_element,
    riccati_backward,
    riccati_backward_fused,
)

SCAN_MODES = ("tree", "ring")


def _element_at(elems: ValueElement, t: int, dim: int = 0) -> ValueElement:
    return ValueElement(*(f.select(dim, t) for f in elems))


def _local_suffix_scan(elems: ValueElement, dim: int = 0) -> ValueElement:
    """Inclusive suffix scan of a block of elements along ``dim``: entry t is ``e_t ∘ e_t+1 ∘ ... ∘ e_last``.

    Sequential composition with the generic ``_combine``, as JAX's
    ``lax.scan`` (one element per step; ``dim`` is the horizon axis counted
    from the left, 1 for the pod-scale pass's (batch, horizon) elements).
    """
    horizon = elems.a.shape[dim]
    carry = _element_at(elems, horizon - 1, dim)
    out = [carry]
    for t in reversed(range(horizon - 1)):
        carry = _combine(_element_at(elems, t, dim), carry)
        out.append(carry)
    out.reverse()
    return ValueElement(*(torch.stack(fields, dim=dim) for fields in zip(*out)))


def _local_block_element(stage_elems: ValueElement, b_seq: torch.Tensor, p_seq: torch.Tensor,
                         tail: ValueElement) -> ValueElement:
    """Fold a block of stage elements into ONE element: ``e_t0 ∘ e_t0+1 ∘ ... ∘ e_t1-1 ∘ tail``.

    Each step is the Woodbury-structured ``_combine_stage_acc`` (the earlier
    operand is always a stage element, whose C = B P has rank m), walked from
    the block's end to its start without keeping the intermediate suffixes.
    """
    acc = tail
    for t in reversed(range(b_seq.shape[0])):
        acc = _combine_stage_acc(_element_at(stage_elems, t), b_seq[t], p_seq[t], acc)
    return acc


def cross_device_exclusive_suffix(
    block_elems: Dict[Coord, ValueElement],
    comm: AxisComm,
    ident: Dict[Coord, ValueElement],
    mode: str = "tree",
) -> Dict[Coord, ValueElement]:
    """Exclusive suffix composition of the shards' block elements over ``comm``'s axis.

    Shard d receives ``block[d+1] ∘ block[d+2] ∘ ... ∘ block[D-1]`` (``ident``,
    the identity element of its shape, on the last shard): the boundary
    value-function halo. Schedules:

    - ``"tree"``: recursive doubling, an inclusive suffix scan with shifts 1,
      2, 4, ... then one shift by 1 to make it exclusive: ceil(log2 D) + 1
      rounds;
    - ``"ring"``: D - 1 shift-by-one hops, one combine per hop.

    Each round is one ``comm.ppermute`` of the whole element.
    """
    if mode not in SCAN_MODES:
        raise ValueError(f"unknown cross-device scan mode {mode!r}")
    num = comm.size
    if num == 1:
        return dict(ident)
    shift_one = [(i, (i - 1) % num) for i in range(num)]
    if mode == "ring":
        acc, incoming = dict(ident), dict(block_elems)
        for hop in range(1, num):
            incoming = comm.ppermute(incoming, shift_one)
            # After `hop` hops shard d holds block[d + hop] (mod D): take it only where it did not wrap around.
            acc = {c: _combine(acc[c], incoming[c]) if comm.axis_index(c) + hop <= num - 1 else acc[c] for c in acc}
        return acc

    suffix = dict(block_elems)
    shift = 1
    while shift < num:  # after this step shard d covers blocks [d, min(d + 2 shift, D))
        shifted = comm.ppermute(suffix, [(i, (i - shift) % num) for i in range(num)])
        suffix = {c: _combine(suffix[c], shifted[c]) if comm.axis_index(c) + shift <= num - 1 else suffix[c]
                  for c in suffix}
        shift *= 2
    shifted = comm.ppermute(suffix, shift_one)
    return {c: ident[c] if comm.axis_index(c) == num - 1 else shifted[c] for c in shifted}


def halo_schedule_spec(n: int, dtype: torch.dtype, num_shards: int, mode: str = "tree") -> dict:
    """What the halo exchange moves and how often: JAX's contract, for a torch dtype.

    The payload of every hop is one ``ValueElement``, ``a (n,n), b (n),
    c (n,n), eta (n), j (n,n)`` = 3n^2 + 2n scalars. Rounds: ``"tree"``
    ceil(log2 D) + 1 (none for D = 1), ``"ring"`` D - 1.
    ``collectives.hops`` counts the same quantities for a run.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    scalars = 3 * n * n + 2 * n
    if mode == "tree":
        rounds = (math.ceil(math.log2(num_shards)) + 1) if num_shards > 1 else 0
    elif mode == "ring":
        rounds = num_shards - 1
    else:
        raise ValueError(f"unknown cross-device scan mode {mode!r}")
    return {
        "payload_scalars_per_hop": scalars,
        "payload_bytes_per_hop": scalars * itemsize,
        "rounds": rounds,
        "total_bytes_per_device": scalars * itemsize * rounds,
    }


def _identity_element(n: int, dtype: torch.dtype, device=None) -> ValueElement:
    """Neutral element of the composition (A = I, b = 0, C = 0, eta = 0, J = 0)."""
    zeros = torch.zeros((n, n), dtype=dtype, device=device)
    return ValueElement(a=torch.eye(n, dtype=dtype, device=device), b=torch.zeros(n, dtype=dtype, device=device),
                        c=zeros, eta=torch.zeros(n, dtype=dtype, device=device), j=zeros)


def _block_riccati(a_seq, b_seq, cost_exp, v_x_edge, v_xx_edge, reg) -> RiccatiResult:
    """Phase 3 on one block: K1 on CUDA where it takes the shape, the plain sequential pass elsewhere."""
    n, m = b_seq.shape[-2:]
    if a_seq.is_cuda and n <= MAX_N and m <= MAX_M:
        return riccati_backward_fused(a_seq, b_seq, cost_exp, v_x_edge, v_xx_edge, reg)
    return riccati_backward(a_seq, b_seq, cost_exp, v_x_edge, v_xx_edge, reg)


def sharded_suffix_value_functions(
    mesh: Mesh,
    a_seq,  # (H, n, n), H divisible by the horizon axis size
    b_seq,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    axis: str = "horizon",
    scan_mode: str = "tree",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V_x[t], V_xx[t]) for t = 0..H-1 with the horizon sharded over ``axis``; full tensors in, full tensors out."""
    res = sharded_riccati_backward(mesh, a_seq, b_seq, cost_exp, v_x_final, v_xx_final, reg, axis, scan_mode)
    return res.v_x_seq[:-1], res.v_xx_seq[:-1]


def sharded_riccati_backward(
    mesh: Mesh,
    a_seq,
    b_seq,
    cost_exp: CostExpansion,
    v_x_final: torch.Tensor,
    v_xx_final: torch.Tensor,
    reg: float = 1e-6,
    axis: str = "horizon",
    scan_mode: str = "tree",
) -> RiccatiResult:
    """Full horizon-partitioned backward pass (the condensing form; see the module docstring).

    ``a_seq``, ``b_seq`` and the fields of ``cost_exp`` are full tensors (the
    result then comes back as full tensors on ``a_seq``'s device) or
    ``GlobalArray``s laid out by ``(axis,)`` (the result then is this
    process's shards: k and K cut like the stages, V_x and V_xx with the
    terminal entry on the last shard, H + 1 in all). ``v_x_final`` and
    ``v_xx_final`` are full tensors.
    """
    if scan_mode not in SCAN_MODES:
        raise ValueError(f"unknown cross-device scan mode {scan_mode!r}")
    comm = AxisComm(mesh, axis, mesh.coords((axis,)))
    num = comm.size
    n = v_x_final.shape[-1]
    stages = [shard(x, mesh, (axis,), comm.coords) for x in (a_seq, b_seq, *cost_exp)]
    local = {c: (stages[0][c], stages[1][c], CostExpansion(*(s[c] for s in stages[2:]))) for c in comm.local}
    edge = {c: (v_x_final.to(mesh.device(c)), v_xx_final.to(mesh.device(c))) for c in comm.local}
    ident = {c: _identity_element(n, v_x_final.dtype, mesh.device(c)) for c in comm.local}

    # 1) condense each block to one element; the last block folds in the terminal element.
    block = {}
    for c, (a, b, exp) in local.items():
        elems, b_fact, p_fact = _stage_elements_with_factors(a, b, exp, reg)
        tail = _terminal_element(*edge[c]) if comm.axis_index(c) == num - 1 else ident[c]
        block[c] = _local_block_element(elems, b_fact, p_fact, tail)

    # 2) the halo exchange.
    acc = cross_device_exclusive_suffix(block, comm, ident, mode=scan_mode)

    # 3) every non-last shard's suffix ends at the terminal element (a = 0, a pure quadratic value
    #    function): V_x = -eta, V_xx = J at its right edge; the last shard uses the terminal pair.
    outs = {}
    for c, (a, b, exp) in local.items():
        last = comm.axis_index(c) == num - 1
        v_x_edge, v_xx_edge = edge[c] if last else (-acc[c].eta, acc[c].j)
        res = _block_riccati(a, b, exp, v_x_edge, v_xx_edge, reg)
        v_x, v_xx = res.v_x_seq[:-1], res.v_xx_seq[:-1]
        if last:
            v_x, v_xx = torch.cat([v_x, edge[c][0][None]]), torch.cat([v_xx, edge[c][1][None]])
        outs[c] = (res.k_seq, res.big_k_seq, v_x, v_xx)

    fields = [{c: out[i] for c, out in outs.items()} for i in range(4)]
    if isinstance(a_seq, GlobalArray):
        horizon, m = a_seq.shape[0], b_seq.shape[-1]
        shapes = ((horizon, m), (horizon, m, n), (horizon + 1, n), (horizon + 1, n, n))
        return RiccatiResult(*(GlobalArray(f, mesh, (axis,), s) for f, s in zip(fields, shapes)))
    return RiccatiResult(*(assemble(f, mesh, (axis,), a_seq.device) for f in fields))
