#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, one run, one fresh process.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds or loads the kernels the cell's path launches (their build
cache is ``quattro_tpu_torch/_build/`` in the checkout), makes the inputs from
the seed and warms up the cell's own shapes. The window then drives the
program for ``--seconds``. Afterwards the plain reference judges a sample of
the window's answers (``reference/``), and the last line of standard output
is the result: the end-to-end metrics with ``--trace 0``; with ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the per-layer
metrics, the device's busy time and a breakdown instead. Each compared number
is printed beside its limit, last on standard error and last in the line.

``--variant control`` puts the cell's control in the program's place (see
``PERF.md``): its run has to come out not correct.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
THREADS = 4


def _args(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--variant", choices=("program", "control"), default="program")
    return parser.parse_args(argv)


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths; a stale build lock removed."""
    cache = ROOT / "bench_cuda" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    # One process per card: a lock left by a run that was cut off would make the build wait forever.
    for lock in (ROOT / "quattro_tpu_torch" / "_build").glob("*/lock"):
        lock.unlink()


def main(argv=None, require_chip: bool = True, device: str = "cuda", root: Path = ROOT) -> int:
    """One run. The tests pass ``require_chip=False`` and a CPU device, and a copy of the benchmark as ``root``."""
    args = _args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_cuda import harness

    cell = harness.Cell(args.workload, root)
    if require_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]):
        print(f"{args.workload} needs {cell.workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(THREADS)
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=args.seed, seconds=args.seconds,
                          device=dev, variant=args.variant, spans=harness.Spans(bool(args.trace)))
    driver = cell.driver
    imported_s = time.perf_counter() - _START
    state = driver.setup(run)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _START

    from quattro_tpu_torch.ops import _build

    _build.reset_launches()
    trace = None
    if args.trace:
        res, events, offset = harness.traced(lambda: driver.window(run, state, args.seconds))
        trace = harness.Trace(events, offset, (res["start_ns"], res["end_ns"]))
    else:
        res = driver.window(run, state, args.seconds)
    launches = dict(_build.launches)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"the run loaded {forbidden}: the benchmark may load none of {harness.FORBIDDEN_MODULES}",
              file=sys.stderr)
        return 3

    end_to_end = driver.end_to_end(run, state, res)
    end_to_end["setup_s"] = setup_s
    attempted, failed = driver.counts(run, state, res)
    judge_start = time.perf_counter()
    numbers, work = driver.judge_run(run, state, res, args.variant)
    work["judge_s"] = time.perf_counter() - judge_start
    checks = {name: {"value": value, "limit": cell.limits[name]} for name, value in numbers.items()}
    correct = failed == 0 and all(harness.finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    if args.trace:
        notes = []
        ctx = SimpleNamespace(trace=trace, launches=launches, config=cell.config, traffic=cell.traffic,
                              work={**{k: v for k, v in res.items() if isinstance(v, (int, float))}, **work},
                              note=notes.append)
        metrics = {}
        for metric in cell.per_layer:
            value = cell.reader(metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        for note in notes:
            print(note, file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps(run.spans.spans)}
    result["checks"] = checks
    print(f"card: {harness.card_state() if on_card else 'none (cpu)'}; workload {args.workload}, seed {args.seed}, "
          f"variant {args.variant}, set-up {setup_s!r} s of which imports {imported_s!r} s, launches {launches}, "
          f"work {work}", file=sys.stderr)
    for name, check in checks.items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
