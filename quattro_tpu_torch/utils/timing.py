"""Phase timing and profiling utilities.

Counterpart of ``quattro_tpu/utils/timing.py``. CUDA launches are
asynchronous, so an honest phase time synchronizes the device that holds the
phase's outputs before the clock stops (where JAX blocks until they are
ready). ``device_trace`` is a ``torch.profiler`` scope.

The program's own spans and counters (``span``, ``count``) are recorded by
``RECORDER`` without ever synchronizing: they mark where the host is inside
an MPC step or a batched trip, on ``time.perf_counter_ns``. They record only
while a ``torch.profiler`` session is active (or as ``tracing`` sets), so a
run that is not traced pays one flag check per span.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

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
        return {name: _summarize(times) for name, times in self.records.items()}

    def reset(self) -> None:
        self.records.clear()


def _summarize(times_s: Sequence[float]) -> Dict[str, float]:
    """Count, total, mean, median and 99th percentile of a list of seconds."""
    arr = np.asarray(times_s)
    return {
        "count": int(arr.size),
        "total_s": float(arr.sum()),
        "mean_s": float(arr.mean()),
        "p50_s": float(np.percentile(arr, 50)),
        "p99_s": float(np.percentile(arr, 99)),
    }


SPAN_CAPACITY = 1 << 17  # spans kept; about 40 s of MPC steps at 1 ms and four spans a step

# A span as ``Recorder.spans`` gives it: (index, name, start_ns, end_ns, parent, device_ms). ``parent`` is the
# index of the enclosing span (-1 for an outermost one); ``device_ms`` the device interval between the span's
# entry and exit on the current CUDA stream, for ``device`` spans on a card, else None.
SpanRecord = Tuple[int, str, int, int, int, Optional[float]]


class _Off:
    """What ``span`` hands back with tracing off: a context manager that does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


class _Span:
    """One open span of ``Recorder.span``."""

    __slots__ = ("recorder", "name", "events", "index", "parent", "start")

    def __init__(self, recorder: "Recorder", name: str, events):
        self.recorder, self.name, self.events = recorder, name, events

    def __enter__(self) -> "_Span":
        rec = self.recorder
        self.index, rec.next_index = rec.next_index, rec.next_index + 1
        self.parent = rec.open[-1] if rec.open else -1
        rec.open.append(self.index)
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.perf_counter_ns()
        rec = self.recorder
        if self.events is not None:
            self.events[1].record()
        rec.open.pop()
        rec.ring.append((self.index, self.name, self.start, end, self.parent, self.events))


class Recorder:
    """Spans and counters of one thread of the program, kept in memory.

    ``span(name)`` times a block on the host's ``perf_counter_ns``, nested
    spans pointing at their parent; ``count(name, value)`` adds to a counter.
    The spans live in a ring of ``capacity``, so a long-running controller
    cannot grow it without end.

    A span with ``device`` set (True, or the device of the block's tensors)
    also records a CUDA event at entry and at exit on the current stream,
    where that device is a card; the interval is read only when ``spans()``
    is called, after the caller's last synchronize. Recording never waits for
    the device.
    """

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.reset()

    def reset(self, capacity: Optional[int] = None) -> None:
        """Drop every span and counter (and resize the ring to ``capacity``, if given)."""
        self.ring = collections.deque(maxlen=capacity or self.ring.maxlen)
        self.counts: Dict[str, float] = {}
        self.open: List[int] = []
        self.next_index = 0

    def span(self, name: str, device=False) -> _Span:
        events = None
        if (device is True and torch.cuda.is_initialized()) or getattr(device, "type", None) == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        return _Span(self, name, events)

    def count(self, name: str, value: float) -> None:
        self.counts[name] = self.counts.get(name, 0) + value

    def spans(self) -> List[SpanRecord]:
        """The closed spans in the order they were opened, device intervals resolved where their events ran."""
        out = []
        for index, name, start, end, parent, events in sorted(self.ring, key=lambda record: record[0]):
            device_ms = None
            if events is not None and events[1].query():
                device_ms = events[0].elapsed_time(events[1])
            out.append((index, name, start, end, parent, device_ms))
        return out

    def counters(self) -> Dict[str, float]:
        return dict(self.counts)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``PhaseTimer.summary``'s numbers for the host durations of the spans, by name."""
        durations: Dict[str, List[float]] = collections.defaultdict(list)
        for _, name, start, end, _, _ in self.spans():
            durations[name].append(1e-9 * (end - start))
        return {name: _summarize(times) for name, times in durations.items()}


RECORDER = Recorder()
spans = RECORDER.spans
counters = RECORDER.counters
reset = RECORDER.reset


def _always() -> bool:
    return True


def _never() -> bool:
    return False


_on = torch._C._autograd._profiler_enabled  # whether ``span`` and ``count`` record; see ``tracing``


def span(name: str, device=False):
    """A context manager that records ``name`` around its block in ``RECORDER`` while tracing is on.

    Tracing is on while a ``torch.profiler`` session is active, unless
    ``tracing`` overrides it. Off, this is one flag check that hands back a
    context manager doing nothing: no clock, no CUDA event, no
    ``record_function``, no host read.
    """
    if not _on():
        return _OFF
    return RECORDER.span(name, device)


def count(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name`` of ``RECORDER`` while tracing is on."""
    if _on():
        RECORDER.count(name, value)


class _Restore:
    """What ``tracing`` hands back: leaving it as a context manager restores the earlier setting."""

    def __init__(self, previous):
        self.previous = previous

    def __enter__(self) -> "_Restore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _on
        _on = self.previous


def tracing(enabled: Optional[bool]) -> _Restore:
    """Record always (True), never (False), or while a profiler session is active (None, the default).

    Takes effect at once; ``with tracing(True):`` restores the earlier
    setting when the block ends.
    """
    global _on
    previous = _on
    _on = {True: _always, False: _never, None: torch._C._autograd._profiler_enabled}[enabled]
    return _Restore(previous)


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
