"""The program's own spans and counters, on the clock of the traced window, for the per-layer readers.

``quattro_tpu_torch.utils.timing`` records them in the run's process while
the harness's profiler session is active. Here each span is mapped onto the
trace with the harness's offset (``ctx.trace.offset_ns``, from its sleep-kernel
marker) and clipped to ``ctx.trace.window_ns``. ``load`` returns None where
the program records nothing: a program without the recorder, or one whose
traced window held no span.

The trace's clock wanders against the host's within a window (on the H100
by up to about 9 ms over seconds, and the marker's offset starts some
0.3-0.9 ms late), so a reader that places spans among device events first
ties the two clocks launch by launch (``clock_tie``) and maps each span with
the tie of its unit of work.

A span here: ``(index, name, start_ns, end_ns, parent, device_ms)``, times on
the trace's clock, ``parent`` the index of the enclosing span (-1 for none).
"""

from __future__ import annotations

import bisect
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

# By driver: the outermost program span of a unit of work; the kernel launched once in each ``holder`` span; the span
# that launches it (the holder's child, or the holder itself); and the holder's child whose host read waits for it.
# ``tight``: the read returns right after the kernel ends (K3: one small copy of its stats between), so the read's
# bound is the tie; a trip runs K7 and its selects between K4 and its read.
UNITS = {
    "mpc": {"outer": "mpc.step", "kernel": re.compile(r"(?<![A-Za-z_])solve_kernel"), "holder": "mpc.step",
            "launch": "mpc.k3_launch", "read": "mpc.stats_read", "tight": True},
    "batch": {"outer": "batch.solve", "kernel": re.compile(r"riccati_batched_kernel"), "holder": "batch.trip",
              "launch": "batch.trip", "read": "batch.done_read", "tight": False},
}


class ProgramSpans:
    """The window's program spans (mapped and clipped) and the run's counters."""

    def __init__(self, records, counters: Dict[str, float], offset_ns: int, window_ns: Tuple[int, int],
                 shift: Callable[[int], int] = lambda t: 0):
        """``shift(t)``: ns to add to the offset for a span whose outermost span starts at trace time t."""
        start, end = window_ns
        records = list(records)
        by_index = {record[0]: record for record in records}
        mapped = []
        for record in records:
            index, name, s, e, parent, device_ms = record
            root = record
            while root[4] in by_index:
                root = by_index[root[4]]
            offset = offset_ns + shift(root[2] + offset_ns)
            s, e = s + offset, e + offset
            if s < end and e > start:
                mapped.append((index, name, max(s, start), min(e, end), parent, device_ms))
        self.spans = sorted(mapped, key=lambda span: (span[2], span[0]))
        self.by_index = {span[0]: span for span in self.spans}
        self.starts = [span[2] for span in self.spans]
        self.counters = counters

    def named(self, name: str) -> List[tuple]:
        return [span for span in self.spans if span[1] == name]

    def children(self, name: str) -> Dict[int, List[tuple]]:
        """The spans called ``name`` by the index of their parent."""
        out: Dict[int, List[tuple]] = {}
        for span in self.named(name):
            out.setdefault(span[4], []).append(span)
        return out

    def innermost(self, t: int) -> Optional[tuple]:
        """The innermost span that holds the trace time ``t``, or None.

        Spans of one thread nest, so the latest-starting span at or before
        ``t`` lies inside the innermost one that holds ``t``: walk up from it.
        """
        i = bisect.bisect_right(self.starts, t) - 1
        span = self.spans[i] if i >= 0 else None
        while span is not None and span[3] <= t:
            span = self.by_index.get(span[4])
        return span

    def outermost(self, span: tuple) -> tuple:
        while span[4] in self.by_index:
            span = self.by_index[span[4]]
        return span


def load(ctx, shift: Callable[[int], int] = lambda t: 0) -> Optional[ProgramSpans]:
    """The program's spans on the trace's clock (the harness's offset, moved by ``shift``), or None."""
    try:
        from quattro_tpu_torch.utils import timing
    except ImportError:
        return None
    read_spans, read_counters = getattr(timing, "spans", None), getattr(timing, "counters", None)
    if read_spans is None or read_counters is None:
        return None
    program = ProgramSpans(read_spans(), read_counters(), ctx.trace.offset_ns, ctx.trace.window_ns, shift)
    return program if program.spans else None


def self_ms(program: ProgramSpans, name: str, child: str) -> Optional[float]:
    """Mean host milliseconds of the spans ``name``, less the time of their children called ``child``."""
    units = program.named(name)
    if not units:
        return None
    kids = program.children(child)
    total = sum(e - s - sum(k[3] - k[2] for k in kids.get(index, ())) for index, _, s, e, _, _ in units)
    return 1e-6 * total / len(units)


class Tie:
    """The host-to-trace tie, launch by launch: each paired launch's shift of the harness's offset."""

    def __init__(self, pairs: List[Tuple[int, int, float, int]], skipped_events: int, skipped_holders: int):
        self.pairs = pairs  # (holder start on the trace under the harness's offset, shift, lowest, highest)
        self.starts = [pair[0] for pair in pairs]
        self.skipped_events, self.skipped_holders = skipped_events, skipped_holders

    def shift(self, t: int) -> int:
        """The shift of the latest paired launch whose holder starts by ``t`` (the first one's before it)."""
        return self.pairs[max(bisect.bisect_right(self.starts, t) - 1, 0)][1]

    def summary(self) -> str:
        shifts = sorted(pair[1] for pair in self.pairs)
        widths = sorted(pair[3] - pair[2] for pair in self.pairs if math.isfinite(pair[2]))
        worst = -max(pair[2] for pair in self.pairs)
        return (f"{len(self.pairs)} launches paired ({self.skipped_events} kernel events and {self.skipped_holders} "
                f"holders left over at the window's edges); the tie moved the harness's offset by {shifts[0]} to "
                f"{shifts[-1]} ns (median {shifts[len(shifts) // 2]}), each launch allowing "
                f"{widths[len(widths) // 2] if widths else 'any'} ns at the median; under the harness's offset alone "
                f"the worst margin between a launch's end and its read's is {worst} ns")


def clock_tie(ctx, program: ProgramSpans, unit: dict) -> Tuple[Optional[Tie], str]:
    """Pair the unit's kernel launches with their spans and tie the clocks at each; (tie, what went wrong or "").

    The kernel runs once in each ``holder`` span, on one stream, so after the
    first pair the k-th event is the k-th launch; the first pair is the one,
    among the first few events and holders, that moves the harness's offset
    least (an edge of the window may cut a launch off). A launch cannot start
    before its ``launch`` span began, nor end after the holder's ``read``
    span (the host read that waits for it) returned, where the holder has one
    (the trip that reaches the last iteration makes none). That bounds the
    shift of the harness's offset at each launch: kernel end - read end <=
    shift <= kernel start - launch start. A launch whose bounds cross means
    the pairing slipped: no tie. Each launch takes the read's bound where the
    unit's read returns right after the kernel (``UNITS[...]["tight"]``),
    else the shift nearest the harness's offset within its bounds.
    """
    events = [(s, e) for name, s, e in ctx.trace.events if unit["kernel"].search(name)]
    holders = program.named(unit["holder"])
    launches = ({holder[0]: holder for holder in holders} if unit["launch"] == unit["holder"]
                else {i: kids[0] for i, kids in program.children(unit["launch"]).items()})
    reads = {i: kids[-1] for i, kids in program.children(unit["read"]).items()}
    units = [(holder[2], launches[holder[0]][2], reads[holder[0]][3] if holder[0] in reads else None)
             for holder in holders if holder[0] in launches]

    def bounds(event, held):
        return (-math.inf if held[2] is None else event[1] - held[2]), event[0] - held[1]

    first = [(abs(min(max(0, lo), hi)), i, j) for i in range(min(3, len(events))) for j in range(min(3, len(units)))
             for lo, hi in [bounds(events[i], units[j])] if lo <= hi]
    if not first:
        return None, f"no pairing of the first of {len(events)} kernel events and {len(units)} {unit['holder']} spans"
    _, i0, j0 = min(first)
    pairs = []
    for event, held in zip(events[i0:], units[j0:]):
        lo, hi = bounds(event, held)
        if lo > hi:
            return None, f"launch {len(pairs)} ends {lo - hi} ns too late for its spans: the pairing slipped"
        pairs.append((held[0], lo if unit["tight"] and math.isfinite(lo) else min(max(0, lo), hi), lo, hi))
    skipped_events, skipped_holders = len(events) - len(pairs), len(units) - len(pairs)
    if max(skipped_events, skipped_holders) > 3:
        return None, f"{skipped_events} kernel events and {skipped_holders} holders left unpaired"
    return Tie(pairs, skipped_events, skipped_holders), ""


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The device's idle intervals in the window, as ``Trace.idle_gaps`` finds them."""
    gaps, reach = [], trace.window_ns[0]
    for _, s, e in trace.events:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if trace.window_ns[1] > reach:
        gaps.append((reach, trace.window_ns[1]))
    return gaps
