"""Debug and validation aids: a non-finite guard, exact tensor checksums and the halo check.

Counterpart of ``quattro_tpu/utils/debug.py``. ``nan_guard`` plays the part of
``jax.debug_nans``: it raises at the first operation whose floating output is
not finite. ``tree_checksum`` sums the leaves' bit patterns modulo 2^32 and
gives the JAX function's value on the same arrays. ``verify_halo_exchange``
checks a ``ppermute`` hop of the horizon shards' halo by a checksum that
travels by a hop of its own.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_MASK32 = 0xFFFFFFFF


class _NonFiniteGuard(TorchDispatchMode):
    """Checks every floating (or complex) tensor an operation returns."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex())
                    and not bool(torch.isfinite(leaf).all())):
                raise FloatingPointError(f"non-finite value in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Within the scope, raise ``FloatingPointError`` at the first operation that returns a NaN or an infinity.

    Every checked output costs a host read, so this is a debugging aid, not a
    mode to leave on in a timed run.
    """
    with _NonFiniteGuard():
        yield


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def tree_checksum(tree) -> torch.Tensor:
    """EXACT order-independent checksum: leaf bit patterns summed modulo 2^32.

    Integer (wraparound) accumulation rather than a float sum, which rounds
    and could absorb a small single-element corruption. Leaves narrower than
    4 bytes (bool, int8, ...) are value-cast; 4- and 8-byte leaves are read
    as their raw little-endian 32-bit words (a float64 gives two). Returns a
    0-d int64 tensor in [0, 2^32) on the first leaf's device.
    """
    total = None
    for leaf in tree_leaves(tree):
        x = _as_tensor(leaf)
        if x.element_size() < 4:  # bool/int8/...: value-cast, still exact
            words = x.to(torch.int64) & _MASK32
        else:  # f32/f64/i32/i64: the raw bits as 32-bit words
            words = x.contiguous().reshape(-1).view(torch.int32).to(torch.int64) & _MASK32
        part = words.sum() & _MASK32
        total = part if total is None else (total + part.to(total.device)) & _MASK32
    return torch.zeros((), dtype=torch.int64) if total is None else total


def verify_halo_exchange(sent: dict, received: dict, comm, perm) -> dict:
    """Check a payload ``ppermute`` by an independent checksum hop.

    ``sent`` and ``received`` map each shard this process holds (by mesh
    coordinate) to its outgoing payload and to what the data-path
    ``comm.ppermute(sent, perm)`` delivered to it; ``comm`` is the
    ``parallel.collectives.AxisComm`` of that hop. Each shard's
    ``tree_checksum`` travels through its own ``ppermute``; where the data
    path corrupted or misrouted the payload the two disagree. Returns, per
    shard, a float32 0-d tensor: 0.0 when consistent, 1.0 on a mismatch.
    Debug-only: costs one extra scalar hop.
    """
    expected = comm.ppermute({c: tree_checksum(tree) for c, tree in sent.items()}, perm)
    return {c: torch.where(expected[c] == tree_checksum(tree).to(expected[c].device), 0.0, 1.0).to(torch.float32)
            for c, tree in received.items()}
