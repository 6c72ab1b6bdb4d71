"""The port stands alone: no module of quattro_tpu_torch, not chip_smoke.py and
not the port's examples (``examples/*_cuda.py`` and the code cells of
``examples/*_cuda.ipynb``) imports JAX, flax, optax or anything of quattro_tpu.

Checked by scanning each file's syntax tree, without importing it.
"""

import ast
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "quattro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_cuda.py")))
NOTEBOOKS = sorted((ROOT / "examples").glob("*_cuda.ipynb"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "quattro_tpu")


def imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) in (
            "__import__", "import_module"
        ):
            yield from (arg.value for arg in node.args if isinstance(arg, ast.Constant) and isinstance(arg.value, str))


def test_the_scan_covers_the_package():
    names = {path.relative_to(ROOT).as_posix() for path in FILES}
    for module in ("quattro_tpu_torch/ops/fused_riccati.py", "quattro_tpu_torch/ops/fused_rollout.py",
                   "quattro_tpu_torch/ops/fused_solve.py", "quattro_tpu_torch/systems/cartpole.py",
                   "quattro_tpu_torch/solver/lqr.py", "quattro_tpu_torch/control/switcher.py",
                   "quattro_tpu_torch/control/mpc.py", "quattro_tpu_torch/models/gain_predictor.py",
                   "quattro_tpu_torch/ops/fused_linquad.py", "quattro_tpu_torch/parallel/batch.py",
                   "quattro_tpu_torch/parallel/__init__.py", "quattro_tpu_torch/ops/smalllu.py",
                   "quattro_tpu_torch/ops/smallchol.py", "quattro_tpu_torch/ops/blocktridiag.py",
                   "quattro_tpu_torch/solver/riccati.py", "quattro_tpu_torch/utils/metrics.py",
                   "quattro_tpu_torch/utils/roofline.py", "quattro_tpu_torch/utils/timing.py",
                   "quattro_tpu_torch/utils/debug.py", "quattro_tpu_torch/utils/__init__.py",
                   "quattro_tpu_torch/io/shardio.py", "quattro_tpu_torch/io/__init__.py",
                   "quattro_tpu_torch/training/collect.py", "quattro_tpu_torch/training/train.py",
                   "quattro_tpu_torch/training/__init__.py", "quattro_tpu_torch/models/torch_port.py",
                   "quattro_tpu_torch/parallel/mesh.py", "quattro_tpu_torch/parallel/collectives.py",
                   "quattro_tpu_torch/parallel/horizon.py", "quattro_tpu_torch/parallel/podscale.py",
                   "quattro_tpu_torch/parallel/distributed.py", "quattro_tpu_torch/sim/__init__.py",
                   "quattro_tpu_torch/sim/mujoco_bridge.py", "quattro_tpu_torch/__init__.py",
                   "examples/collect_and_train_cuda.py", "examples/cartpole_sim_cuda.py",
                   "examples/quadrotor_sim_cuda.py", "examples/plot_results_cuda.py", "chip_smoke.py"):
        assert module in names


def test_the_scan_sees_a_forbidden_import():
    tree = ast.parse("import numpy\nfrom quattro_tpu.systems import quadrotor\nimport jax.numpy as jnp\n")
    assert [m for m in imported_modules(tree) if m.split(".")[0] in FORBIDDEN] == ["quattro_tpu.systems", "jax.numpy"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_quattro_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_covers_the_notebook():
    assert [p.name for p in NOTEBOOKS] == ["training_walkthrough_cuda.ipynb"]


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_quattro_tpu_import_in_notebook_cells(path):
    cells = ["".join(c["source"]) for c in json.loads(path.read_text())["cells"] if c["cell_type"] == "code"]
    assert cells
    for i, source in enumerate(cells):
        bad = [m for m in imported_modules(ast.parse(source)) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.relative_to(ROOT)} code cell {i} imports {bad}"
