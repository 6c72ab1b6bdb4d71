"""Collectives over one mesh axis: the port's counterpart of ``lax.ppermute``, ``lax.psum`` and ``lax.axis_index``.

A sharded value is a dict from mesh coordinate to that shard's tensor, or to
a pytree of tensors (a ``ValueElement``, a list of gradients), for the shards
this process holds. ``AxisComm`` runs a collective over one axis of the mesh
as explicit rounds:

- within a process it moves each tensor to the receiving shard's device
  (``Tensor.to``, which hands back the tensor itself when the two shards
  share a device, as on a virtual mesh);
- between processes it goes through ``torch.distributed``: the hops of a
  ``ppermute`` as one ``batch_isend_irecv``, a ``psum`` as one ``all_reduce``
  per leaf (NCCL for CUDA tensors, gloo for CPU tensors: the backend
  ``distributed.initialize`` sets up).

``hops`` counts each ``ppermute`` round and the bytes one shard sends in it,
as ``ops/_build.py::launches`` counts kernel launches: it stands in for the
JAX package's check of the lowered collective-permutes, and a test holds it
to ``horizon.halo_schedule_spec``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from quattro_tpu_torch.parallel.mesh import Coord, Mesh, process_rank


class HopCounter:
    """``rounds``: ppermute rounds since the last ``reset``; ``bytes_per_hop``: the payload one shard sent in each."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.rounds = 0
        self.bytes_per_hop: List[int] = []

    def add(self, nbytes: int) -> None:
        self.rounds += 1
        self.bytes_per_hop.append(nbytes)


hops = HopCounter()


def _nbytes(leaves: Iterable[torch.Tensor]) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves)


class AxisComm:
    """Collectives over ``axis`` among the shards at ``coords`` (every process passes the same coordinates)."""

    def __init__(self, mesh: Mesh, axis: str, coords: Sequence[Coord]):
        self.mesh, self.axis = mesh, axis
        self.pos = mesh.axis_pos(axis)
        self.size = mesh.shape[axis]
        self.coords = list(coords)
        self.local = [c for c in self.coords if mesh.is_local(c)]

    def axis_index(self, coord: Coord) -> int:
        """The shard's index along the axis (``lax.axis_index``)."""
        return coord[self.pos]

    def _moved(self, coord: Coord, index: int) -> Coord:
        return coord[: self.pos] + (index,) + coord[self.pos + 1:]

    def ppermute(self, values: Dict[Coord, object], perm: Sequence[Tuple[int, int]]) -> Dict[Coord, object]:
        """Send each shard's value from axis index ``src`` to ``dst`` for every ``(src, dst)`` of ``perm``.

        A shard that no pair sends to receives zeros, as in ``lax.ppermute``.
        Counts one round in ``hops``.
        """
        flat = {c: tree_flatten(values[c]) for c in self.local}
        if not flat:
            return {}
        me = process_rank()
        out, ops, received = {}, [], []
        tag = 0
        for coord in self.coords:
            for src, dst in perm:
                if coord[self.pos] != src:
                    continue
                target = self._moved(coord, dst)
                src_rank, dst_rank = self.mesh.rank(coord), self.mesh.rank(target)
                if src_rank == me and dst_rank == me:
                    out[target] = [leaf.to(self.mesh.device(target)) for leaf in flat[coord][0]]
                elif src_rank == me:
                    ops += [dist.P2POp(dist.isend, leaf.contiguous(), dst_rank, tag=tag + j)
                            for j, leaf in enumerate(flat[coord][0])]
                elif dst_rank == me:
                    bufs = [torch.empty(leaf.shape, dtype=leaf.dtype, device=self.mesh.device(target))
                            for leaf in flat[target][0]]
                    ops += [dist.P2POp(dist.irecv, buf, src_rank, tag=tag + j) for j, buf in enumerate(bufs)]
                    received.append((target, bufs))
                tag += len(flat[self.local[0]][0])
        if ops:
            for request in dist.batch_isend_irecv(ops):
                request.wait()
        out.update(received)
        hops.add(_nbytes(flat[self.local[0]][0]))
        return {c: tree_unflatten(out.get(c) or [torch.zeros_like(leaf) for leaf in flat[c][0]], flat[c][1])
                for c in self.local}

    def psum(self, values: Dict[Coord, object]) -> Dict[Coord, object]:
        """Sum the shards' values over the axis; every shard receives its group's sum (``lax.psum``)."""
        flat = {c: tree_flatten(values[c]) for c in self.local}
        if not flat:
            return {}

        def group(c):
            return self._moved(c, 0)

        partial: Dict[Coord, list] = {}
        for c in self.local:
            key = group(c)
            if key in partial:
                home = partial[key][0].device
                partial[key] = [p + leaf.to(home) for p, leaf in zip(partial[key], flat[c][0])]
            else:
                partial[key] = list(flat[c][0])
        if self.mesh.spans_processes():
            keys = sorted({group(c) for c in self.coords})
            home = self.mesh.device(self.local[0])
            totals = {key: [] for key in keys}
            for j, leaf in enumerate(flat[self.local[0]][0]):
                stacked = torch.zeros((len(keys),) + tuple(leaf.shape), dtype=leaf.dtype, device=home)
                for i, key in enumerate(keys):
                    if key in partial:
                        stacked[i] = partial[key][j].to(home)
                dist.all_reduce(stacked)
                for i, key in enumerate(keys):
                    totals[key].append(stacked[i])
            partial = totals
        return {c: tree_unflatten([t.to(self.mesh.device(c)) for t in partial[group(c)]], flat[c][1])
                for c in self.local}
