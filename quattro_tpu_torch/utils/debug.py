"""Debug and validation aids: a non-finite guard and exact tensor checksums.

Counterpart of ``quattro_tpu/utils/debug.py``. ``nan_guard`` plays the part of
``jax.debug_nans``: it raises at the first operation whose floating output is
not finite. ``tree_checksum`` sums the leaves' bit patterns modulo 2^32 and
gives the JAX function's value on the same arrays. ``verify_halo_exchange``
(a checksum carried beside a horizon shard's halo) comes with the port of
``parallel/horizon.py`` (ROADMAP.md, Queue 1 item 8).
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
