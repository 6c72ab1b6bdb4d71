"""What every cell shares: the manifest, finding a cell's files by name, spans, the trace, the result line.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json`` gives
it:

- ``configs/<config>.json``: the plant, its sizes and cost tables, the start
  envelope, and the program's entry points for it;
- ``traffic/<traffic>.json``: the mix's parameters, and the driver that runs
  it (``drivers/<driver>.py``);
- ``limits/<workload>.json``: each compared number's limit in that cell;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric,
  returning a number or None where it finds nothing to read. A metric split
  by the cells' end-to-end metrics (``mfu.mpc``, ``mfu.batch``) falls back to
  the reader of its base name (``metrics/mfu.py``) where it has none of its own.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "quattro_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix, limits and metrics."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = manifest(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        config = next(c for c in bench["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(root / config["file"])
        self.traffic = load_json(root / "bench_cuda" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "bench_cuda" / "limits" / f"{name}.json")
        self.driver = load_module(root / "bench_cuda" / "drivers" / f"{self.traffic['driver']}.py",
                                  f"bench_cuda_driver_{self.traffic['driver']}")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.root = root

    def reader(self, metric: str):
        metrics = self.root / "bench_cuda" / "metrics"
        path = metrics / f"{metric}.py"
        if not path.exists():
            path = metrics / f"{metric.split('.', 1)[0]}.py"
        return load_module(path, f"bench_cuda_metric_{path.stem}")


class Spans:
    """Host spans (name, start ns, end ns) on ``time.perf_counter_ns``, kept in memory; off unless traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        if self.enabled:
            self.spans.append((name, start_ns, end_ns))


class Trace:
    """The device events of a traced window, and the window on the host's clock."""

    def __init__(self, events, offset_ns: int, window: Tuple[int, int]):
        start, end = window[0] + offset_ns, window[1] + offset_ns
        clipped = ((name, max(s, start), min(s + d, end)) for name, s, d in events if s < end and s + d > start)
        self.events = sorted((event for event in clipped if event[2] > event[1]), key=lambda event: event[1])
        self.offset_ns = offset_ns
        self.window_ns = (start, end)

    @property
    def window_s(self) -> float:
        return 1e-9 * (self.window_ns[1] - self.window_ns[0])

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: ``chip_smoke.py:1478`` ``idle_share``'s sum of the
        trace's device events, with overlapping events counted once."""
        busy, reach = 0, self.window_ns[0]
        for _, s, e in self.events:
            if e > reach:
                busy += e - max(s, reach)
                reach = e
        return 1e-9 * busy

    def kernel_s(self, pattern) -> float:
        """Device seconds of the events whose name matches the compiled regex ``pattern``."""
        return 1e-9 * sum(e - s for name, s, e in self.events if pattern.search(name))

    def top_ops(self, count: int = 10):
        by_name: Dict[str, int] = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda item: -item[1])[:count]
        return [[name[:160], 1e-9 * ns] for name, ns in top]

    def idle_gaps(self, spans: List[Tuple[str, int, int]], count: int = 10):
        """Idle device time, summed by the innermost host span around each gap's middle."""
        gaps, reach = [], self.window_ns[0]
        for _, s, e in self.events:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if self.window_ns[1] > reach:
            gaps.append((reach, self.window_ns[1]))
        ordered = sorted(spans, key=lambda span: span[1])
        starts = [span[1] for span in ordered]
        by_span: Dict[str, int] = {}
        for s, e in gaps:
            middle = (s + e) // 2 - self.offset_ns
            name = "harness"
            # The latest-starting span that holds the middle: spans nest only a few deep.
            for i in range(bisect.bisect_right(starts, middle) - 1, max(-1, bisect.bisect_right(starts, middle) - 9), -1):
                if ordered[i][2] > middle:
                    name = ordered[i][0]
                    break
            by_span[name] = by_span.get(name, 0) + (e - s)
        top = sorted(by_span.items(), key=lambda item: -item[1])[:count]
        return [[f"idle during {name}", 1e-9 * ns] for name, ns in top]


def traced(fn):
    """Run ``fn()`` under ``torch.profiler`` (device activity only); returns (fn's result, device events, offset ns).

    A short sleep kernel, launched right after the host's clock is read, ties
    the trace's clock to the host's: the offset maps a host ``perf_counter_ns``
    onto the trace, to within a launch's latency.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        marker_host = time.perf_counter_ns()
        torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        result = fn()
        torch.cuda.synchronize()
    events = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler's trace holds no device events")
    marker = min(events, key=lambda event: event[1])
    return result, events, marker[1] - marker_host


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not load, compared whole."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def card_state() -> Optional[str]:
    """``nvidia-smi``'s name, power limit, SM clock (now and its maximum) and temperature of the card, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def finite(value) -> bool:
    return value is not None and math.isfinite(value)
