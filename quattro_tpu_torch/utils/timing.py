"""Phase timing and profiling utilities.

Counterpart of ``quattro_tpu/utils/timing.py``. CUDA launches are
asynchronous, so an honest phase time synchronizes the device that holds the
phase's outputs before the clock stops (where JAX blocks until they are
ready). ``device_trace`` is a ``torch.profiler`` scope.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


def _wait_for(outputs) -> None:
    """Synchronize every CUDA device that holds a tensor of ``outputs`` (any pytree)."""
    for device in {leaf.device for leaf in tree_leaves(outputs)
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates per-phase wall times.

    Usage:
        timer = PhaseTimer()
        result_box = []
        with timer.phase("backward", outputs=lambda: result_box):
            result_box.append(backward(...))
        # or, simpler, for a single call:
        result = timer.timed("backward", backward, ...)
        timer.summary()  # {phase: {count, total_s, mean_s, p50_s, p99_s}}

    Without a wait a phase records only the launch time while the device
    work runs after the ``with`` block exits. ``phase(..., outputs=...)``
    synchronizes the devices of the callable's result at exit; ``timed`` those
    of the function's return value. A bare ``phase(name)`` is honest only
    around host-synchronous work (pure Python/numpy, or code that already
    read a result on the host).
    """

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, outputs=None):
        """Time a block; ``outputs`` (a zero-argument callable returning the
        block's tensors) is waited for before the clock stops."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if outputs is not None:
                _wait_for(outputs())
            self.records[name].append(time.perf_counter() - start)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs, record the elapsed time."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait_for(out)
        self.records[name].append(time.perf_counter() - start)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        result = {}
        for name, times in self.records.items():
            arr = np.asarray(times)
            result[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p99_s": float(np.percentile(arr, 99)),
            }
        return result

    def reset(self) -> None:
        self.records.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` scope (host, and the card where there is one); the trace is written to ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def block_nnz_per_sec(num_blocks: int, elapsed_s: float, bands: int = 3) -> float:
    """Block-nonzeros processed per second for a block-tridiagonal factorization
    (diagonal + 2 off-diagonal bands per row)."""
    nnz = num_blocks + 2 * (num_blocks - 1) if bands == 3 else num_blocks * bands
    return nnz / elapsed_s
