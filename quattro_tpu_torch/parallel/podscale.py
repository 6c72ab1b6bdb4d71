"""Pod-scale sharding: trajectory batch x horizon partitioning (counterpart of ``quattro_tpu/parallel/podscale.py``).

BASELINE.json config 5: 4,096 parallel trajectories at H = 1,024 with the
Riccati factorization horizon-partitioned. The 2-D mesh ("traj", "horizon")
cuts the LQ batch over the first axis and each trajectory's horizon over the
second; a shard runs the local associative pass for its (batch shard x
horizon block) and exchanges boundary value elements with its horizon
neighbours only.

The JAX function vmaps a per-trajectory body inside ``shard_map``. Here the
body is written over the shard's leading batch axis instead (no
``torch.func.vmap``: a kernel launched through ctypes cannot run on vmap's
tensors), so each shard's stage elements and its gain extraction are each
one ``_spd_solve`` over all of its (batch x horizon) systems: one launch of
kernel K8 each on CUDA.
"""

from __future__ import annotations

import torch

from quattro_tpu_torch.parallel.collectives import AxisComm
from quattro_tpu_torch.parallel.horizon import _identity_element, _local_suffix_scan, cross_device_exclusive_suffix
from quattro_tpu_torch.parallel.mesh import GlobalArray, Mesh, assemble, shard
from quattro_tpu_torch.solver.derivatives import CostExpansion
from quattro_tpu_torch.solver.riccati import (
    RiccatiResult,
    ValueElement,
    _combine,
    _gains,
    _stage_elements,
    _terminal_element,
)


def podscale_riccati_backward(
    mesh: Mesh,
    a_seq,  # (B, H, n, n)
    b_seq,  # (B, H, n, m)
    cost_exp: CostExpansion,  # fields (B, H, ...)
    v_x_final,  # (B, n)
    v_xx_final,  # (B, n, n)
    reg: float = 1e-6,
    batch_axis: str = "traj",
    horizon_axis: str = "horizon",
    scan_mode: str = "tree",
) -> RiccatiResult:
    """Batched, horizon-partitioned backward Riccati over a 2-D mesh.

    B must be divisible by the ``batch_axis`` size, H by the ``horizon_axis``
    size. Returns gains (B, H, m[, n]) and value sequences (B, H+1, ...): full
    tensors on ``a_seq``'s device, or, for ``GlobalArray`` inputs (stages laid
    out by ``(batch_axis, horizon_axis)``, the terminal pair by
    ``(batch_axis,)``), this process's shards, with the terminal entry of
    the value sequences on the last horizon shard.
    """
    comm = AxisComm(mesh, horizon_axis, mesh.coords((batch_axis, horizon_axis)))
    num_h = comm.size
    spec = (batch_axis, horizon_axis)
    stages = [shard(x, mesh, spec, comm.coords) for x in (a_seq, b_seq, *cost_exp)]
    finals = [shard(x, mesh, (batch_axis,), comm.coords) for x in (v_x_final, v_xx_final)]
    n = v_x_final.shape[-1]

    local, ident, block, local_main = {}, {}, {}, {}
    for c in comm.local:
        a, b, exp = stages[0][c], stages[1][c], CostExpansion(*(s[c] for s in stages[2:]))
        local[c] = (a, b, exp)
        ident[c] = ValueElement(*(f.expand((a.shape[0],) + tuple(f.shape))
                                  for f in _identity_element(n, a.dtype, a.device)))
        elems = _stage_elements(a, b, exp, reg)  # (B_loc, H_loc, ...): one K8 launch on CUDA
        last = comm.axis_index(c) == num_h - 1
        tail = _terminal_element(finals[0][c], finals[1][c]) if last else ident[c]
        elems = ValueElement(*(torch.cat([e, t[:, None]], dim=1) for e, t in zip(elems, tail)))
        suffix = _local_suffix_scan(elems, dim=1)
        block[c] = ValueElement(*(f[:, 0] for f in suffix))
        local_main[c] = ValueElement(*(f[:, :-1] for f in suffix))

    # Exclusive suffix of the block elements along the horizon axis, batched over the local trajectories.
    acc = cross_device_exclusive_suffix(block, comm, ident, mode=scan_mode)

    values = {}
    for c in comm.local:
        horizon = local_main[c].a.shape[1]
        boundary = ValueElement(*(f[:, None].expand((f.shape[0], horizon) + tuple(f.shape[1:])) for f in acc[c]))
        combined = _combine(local_main[c], boundary)  # (B_loc, H_loc, ...)
        values[c] = (-combined.eta, combined.j)

    # Gains need V at t + 1: shift left within the block, pulling the first entry of the right
    # neighbour (the terminal V on the last shard): one more ppermute.
    firsts = comm.ppermute({c: (v_x[:, :1], v_xx[:, :1]) for c, (v_x, v_xx) in values.items()},
                           [(i, (i - 1) % num_h) for i in range(num_h)])
    outs = {}
    for c, (a, b, exp) in local.items():
        v_x, v_xx = values[c]
        if comm.axis_index(c) == num_h - 1:
            nxt_x, nxt_xx = finals[0][c][:, None], finals[1][c][:, None]
        else:
            nxt_x, nxt_xx = firsts[c]
        k, big_k = _gains(a, b, exp, torch.cat([v_x[:, 1:], nxt_x], dim=1), torch.cat([v_xx[:, 1:], nxt_xx], dim=1),
                          reg)  # one K8 launch on CUDA
        if comm.axis_index(c) == num_h - 1:
            v_x, v_xx = torch.cat([v_x, nxt_x], dim=1), torch.cat([v_xx, nxt_xx], dim=1)
        outs[c] = (k, big_k, v_x, v_xx)

    fields = [{c: out[i] for c, out in outs.items()} for i in range(4)]
    if isinstance(a_seq, GlobalArray):
        batch, horizon, m = a_seq.shape[0], a_seq.shape[1], b_seq.shape[-1]
        shapes = ((batch, horizon, m), (batch, horizon, m, n), (batch, horizon + 1, n), (batch, horizon + 1, n, n))
        return RiccatiResult(*(GlobalArray(f, mesh, spec, s) for f, s in zip(fields, shapes)))
    return RiccatiResult(*(assemble(f, mesh, spec, a_seq.device) for f in fields))
