"""Helpers of the benchmark's own tests: a copy of the benchmark to change, and small CPU runs of a cell."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes a CPU test run can hold: the cells' traffic with short episodes and small batches.
SMALL = {
    "mpc-megakernel": {"episode_steps": 3, "warmup_steps": 1, "sampled_steps": 1, "judged_firsts": 1, "max_judged": 3},
    "batch-65536": {"batch": 16, "judged_per_call": 3, "max_judged": 6},
}


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and bench_cuda/ (without its tests and caches) as a checkout's root."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_cuda", tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    return tmp_path


@pytest.fixture
def small_copy(bench_copy):
    """``bench_copy`` with every traffic mix cut to the sizes in ``SMALL``."""
    for mix, changes in SMALL.items():
        path = bench_copy / "bench_cuda" / "traffic" / f"{mix}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **changes}))
    return bench_copy


def run_cell(root, workload, capsys, variant="program", seed=2**31 + 11, seconds=0.5):
    """One CPU run of ``workload`` under ``root``; returns the parsed result line."""
    from bench_cuda import run

    assert run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
                     "--variant", variant], require_chip=False, device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
