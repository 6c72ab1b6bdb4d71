"""Device meshes and tensors split over them (counterpart of ``quattro_tpu/parallel/mesh.py``).

PyTorch has no ``jax.sharding``, so the port keeps a small one of its own:

- ``Mesh``: a named grid of ``torch.device``s, each entry owned by one
  process (its rank). Every entry of a ``make_mesh`` mesh belongs to the
  calling process; ``distributed.global_mesh`` builds one that spans
  processes. A grid may name one device more than once (a virtual mesh: its
  shards run one after another on that device), which is how one card or one
  CPU stands in for several devices.
- A spec (the counterpart of ``PartitionSpec``): one mesh axis name, or
  ``None``, per leading tensor dimension; a dimension named by an axis is cut
  into that axis's size of equal chunks.
- ``GlobalArray``: a tensor split over a mesh, as this process holds it: its
  shards keyed by mesh coordinate, the mesh, the spec and the global shape.
  ``distributed.host_local_to_global`` makes one; every sharded entry point of
  ``parallel/`` takes one in place of a full tensor and then returns its
  results as ``GlobalArray``s too.

A sharded function runs bulk-synchronously: it splits its inputs into shards
on the mesh's devices, runs the local phase for each shard this process
holds, and runs each collective as explicit rounds over the shards
(``parallel/collectives.py``). A mesh axis that a function's spec does not
name is replicated in JAX; here its shards are computed once, on the entries
at coordinate 0 of that axis.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from quattro_tpu_torch.device import DeviceLike, resolve_device

Coord = Tuple[int, ...]
Spec = Tuple[Optional[str], ...]
SpecLike = Union[None, str, Sequence[Optional[str]]]


def process_rank() -> int:
    """This process's rank in the distributed runtime; 0 when there is none."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A named grid of devices: ``devices`` (an object array of ``torch.device``) and the rank owning each entry."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], ranks: Optional[np.ndarray] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs {devices.ndim} axis names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = np.full(devices.shape, process_rank()) if ranks is None else np.asarray(ranks).reshape(
            devices.shape)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_pos(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def device(self, coord: Coord) -> torch.device:
        return self.devices[coord]

    def rank(self, coord: Coord) -> int:
        return int(self.ranks[coord])

    def is_local(self, coord: Coord) -> bool:
        return self.rank(coord) == process_rank()

    def spans_processes(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    def coords(self, axes: Sequence[str]) -> list:
        """Every coordinate along ``axes`` (row-major), with the mesh's other axes at 0."""
        for name in axes:
            self.axis_pos(name)
        positions = [range(self.shape[name]) if name in axes else (0,) for name in self.axis_names]
        return [tuple(c) for c in itertools.product(*positions)]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


class GlobalArray(NamedTuple):
    """A tensor split over a mesh, as this process holds it."""

    shards: Dict[Coord, torch.Tensor]  # this process's shards, by mesh coordinate
    mesh: Mesh
    spec: Spec
    shape: Tuple[int, ...]  # the global shape


def default_devices() -> list:
    """Every visible CUDA device; raises without a card (a mesh over the CPU is made only on request)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that two names of one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(
    axis_shapes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("traj", "horizon"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a named mesh over this process's devices.

    Defaults: every visible CUDA device, all on the ``traj`` axis and 1 on
    the others. For the horizon-partitioned Riccati pass give e.g.
    ``axis_shapes=(1, 8)``. ``devices`` may repeat a device (a virtual mesh,
    e.g. ``["cpu"] * 8`` or ``["cuda:0"] * 8``).
    """
    devs = [_indexed(resolve_device(d)) for d in devices] if devices is not None else default_devices()
    if axis_shapes is None:
        axis_shapes = (len(devs),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_shapes)) != len(devs):
        raise ValueError(f"axis_shapes {axis_shapes} != device count {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(axis_shapes), axis_names)


def traj_sharding(mesh: Mesh, axis: str = "traj") -> Spec:
    """The spec that shards the leading (trajectory-batch) axis over ``axis`` of the mesh."""
    mesh.axis_pos(axis)
    return (axis,)


def normalize_spec(spec: SpecLike) -> Spec:
    """A spec as a tuple: one axis name (or ``None``) per leading dimension; ``None`` or ``()`` replicates."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def _block_index(mesh: Mesh, spec: Spec, shape: Sequence[int], coord: Coord) -> tuple:
    """The slices of a tensor of ``shape`` that the shard at ``coord`` holds."""
    index = []
    for dim, name in enumerate(spec):
        if name is None:
            index.append(slice(None))
            continue
        size = mesh.shape[name]
        if shape[dim] % size:
            raise ValueError(f"dimension {dim} of size {shape[dim]} is not divisible by mesh axis {name!r} "
                             f"of size {size}")
        chunk = shape[dim] // size
        start = coord[mesh.axis_pos(name)] * chunk
        index.append(slice(start, start + chunk))
    return tuple(index)


def shard(x, mesh: Mesh, spec: SpecLike, coords: Sequence[Coord]) -> Dict[Coord, torch.Tensor]:
    """This process's shards of ``x`` at ``coords``, each on its mesh device.

    ``x`` is a full tensor (cut here; a shard on the tensor's own device is a
    view of it) or a ``GlobalArray`` laid out by ``spec`` over ``mesh``.
    """
    spec = normalize_spec(spec)
    local = [c for c in coords if mesh.is_local(c)]
    if isinstance(x, GlobalArray):
        if x.mesh is not mesh or normalize_spec(x.spec) != spec:
            raise ValueError(f"GlobalArray laid out by {x.spec} over {x.mesh}, expected {spec} over {mesh}")
        missing = [c for c in local if c not in x.shards]
        if missing:
            raise ValueError(f"GlobalArray holds no shard at {missing}")
        return {c: x.shards[c] for c in local}
    return {c: x[_block_index(mesh, spec, x.shape, c)].to(mesh.device(c)) for c in local}


def assemble(shards: Dict[Coord, torch.Tensor], mesh: Mesh, spec: SpecLike, device: DeviceLike) -> torch.Tensor:
    """Concatenate shards along the spec's dimensions onto ``device``.

    The shards may hold a part of the axis only (this process's part of a
    ``GlobalArray``) and need not be of equal size; of shards that replicate
    one block over a mesh axis the spec does not name, the first is taken.
    """
    spec = normalize_spec(spec)
    items = {c: t.to(device) for c, t in shards.items()}
    for dim in reversed(range(len(spec))):
        if spec[dim] is None:
            continue
        pos = mesh.axis_pos(spec[dim])
        groups: Dict[Coord, list] = {}
        for c, t in items.items():
            groups.setdefault(c[:pos] + (0,) + c[pos + 1:], []).append((c[pos], t))
        items = {key: torch.cat([t for _, t in sorted(parts, key=lambda p: p[0])], dim=dim)
                 for key, parts in groups.items()}
    return items[min(items)]
