"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from bench_cuda.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "quattro_tpu"}

PROBE = """
import importlib.util, json, pathlib, sys
sys.path.insert(0, {root!r})
bench = pathlib.Path({root!r}) / "bench_cuda"
import bench_cuda.run, bench_cuda.harness, bench_cuda.generate
for path in sorted(bench.rglob("*.py")):
    if "tests" in path.parts or path.name == "__init__.py":
        continue
    spec = importlib.util.spec_from_file_location("probe_" + str(len(sys.modules)), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import quattro_tpu_torch.control, quattro_tpu_torch.parallel.batch, quattro_tpu_torch.ops._build
print(json.dumps(sorted({{name.split(".", 1)[0] for name in sys.modules}})))
"""


def test_no_forbidden_top_level_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "quattro_tpu_torch" in loaded and "bench_cuda" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench_cuda" / "reference").glob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"quattro_tpu_torch"}), (path, tops)


def test_benchmark_sources_import_no_jax():
    for path in (ROOT / "bench_cuda").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops)
