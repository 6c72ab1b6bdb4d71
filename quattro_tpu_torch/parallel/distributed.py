"""Multi-process runtime: ``torch.distributed`` bootstrap, a global mesh, host-local data feed.

Counterpart of ``quattro_tpu/parallel/distributed.py``. Every process of a
multi-process program calls ``initialize`` once; ``global_mesh`` then builds
a mesh over every process's devices, and the sharded functions of
``parallel/`` run over it unchanged: a collective between two shards of one
process moves tensors, one between processes goes through
``torch.distributed`` (``parallel/collectives.py``).

Launch: start the same program in every process, with ``torchrun`` (which
sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) or with
``initialize("host:port", num_processes, process_id)``. The process group
runs NCCL for CUDA tensors and gloo for CPU tensors
(``"cpu:gloo,cuda:nccl"``; gloo alone where this PyTorch has no CUDA). The
TPU pod metadata probe of the JAX module has no counterpart.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.parallel.mesh import (
    GlobalArray, Mesh, SpecLike, _indexed, assemble, default_devices, make_mesh, normalize_spec,
)


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or skip) the multi-process runtime; idempotent.

    ``coordinator_address`` is ``"host:port"`` of process 0; without it the
    rendezvous variables ``MASTER_ADDR`` and ``MASTER_PORT`` (and
    ``WORLD_SIZE``, ``RANK`` for the counts not given) are read. Returns True
    if a process group is active after the call. With no address and no
    variables this is a clean no-op that returns False (library code may call
    it unconditionally). A failed setup raises.
    """
    if is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False  # single-process mode
    if num_processes is None or process_id is None:
        raise ValueError(f"initialize({coordinator_address!r}) needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id)
    return True


def process_info() -> Tuple[int, int]:
    """(process_index, process_count): (0, 1) when single-process."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(
    axis_shapes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("traj", "horizon"),
    local_devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Named mesh over every process's devices, process 0's first.

    ``local_devices``: this process's devices (default: every visible CUDA
    device; a CPU mesh, e.g. ``["cpu"]``, only when given). Same semantics as
    ``make_mesh``, which it is in a single process. Default: everything on
    the ``traj`` axis.
    """
    local = [_indexed(resolve_device(d)) for d in local_devices] if local_devices is not None else default_devices()
    if not is_initialized():
        return make_mesh(axis_shapes, axis_names, devices=local)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in local])
    devices = [torch.device(d) for names in everyone for d in names]
    ranks = [rank for rank, names in enumerate(everyone) for _ in names]
    if axis_shapes is None:
        axis_shapes = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_shapes)) != len(devices):
        raise ValueError(f"axis_shapes {axis_shapes} != device count {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(axis_shapes), axis_names, np.asarray(ranks).reshape(axis_shapes))


def host_local_to_global(mesh: Mesh, spec: SpecLike, host_local) -> GlobalArray:
    """Assemble this process's slice of a batch into its shards of the global array.

    ``host_local`` (a tensor or numpy array) is the part of the global array
    that this process's mesh entries hold, their blocks concatenated in mesh
    order along each dimension the spec names (e.g. the trajectories whose
    data this process generated). Each block goes to its entry's device.
    """
    spec = normalize_spec(spec)
    x = host_local if isinstance(host_local, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(host_local))
    local = [c for c in np.ndindex(*mesh.devices.shape) if mesh.is_local(c)]
    shape = list(x.shape)
    blocks = []  # per dimension: None, or (mesh axis position, {position: block index here}, block size)
    for dim, name in enumerate(spec):
        if name is None:
            blocks.append(None)
            continue
        pos = mesh.axis_pos(name)
        held = sorted({c[pos] for c in local})
        if x.shape[dim] % len(held):
            raise ValueError(f"host-local dimension {dim} of size {x.shape[dim]} does not split into "
                             f"{len(held)} blocks")
        size = x.shape[dim] // len(held)
        shape[dim] = size * mesh.shape[name]
        blocks.append((pos, {p: i for i, p in enumerate(held)}, size))

    def index(c):
        return tuple(slice(None) if blk is None else slice(blk[1][c[blk[0]]] * blk[2], (blk[1][c[blk[0]]] + 1) * blk[2])
                     for blk in blocks)

    shards = {c: x[index(c)].to(mesh.device(c)) for c in local}
    return GlobalArray(shards, mesh, spec, tuple(shape))


def global_to_host_local(mesh: Mesh, spec: SpecLike, global_arr: GlobalArray) -> torch.Tensor:
    """Inverse of ``host_local_to_global``: this process's blocks, concatenated, on its first device."""
    first = min(global_arr.shards)
    return assemble(global_arr.shards, mesh, spec, mesh.device(first))


def barrier() -> None:
    """Block until every process reaches this point (a no-op in a single process)."""
    if is_initialized():
        dist.barrier()
