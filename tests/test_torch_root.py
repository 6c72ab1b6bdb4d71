"""The port's package root: JAX's public names, the same objects as in its subpackages, and a lazy import.

``quattro_tpu_torch`` exports every name of ``quattro_tpu.__all__``, each the
object its ``solver`` or ``models`` subpackage holds, the same ``__version__``,
and the two reference checkpoint locations. Importing it builds and loads no
kernel.
"""

import os
import pathlib
import subprocess
import sys

import quattro_tpu
import quattro_tpu_torch
from quattro_tpu.models import torch_port as jtorch_port
from quattro_tpu_torch import models, solver

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_root_exports_jax_names():
    assert set(quattro_tpu.__all__) <= set(quattro_tpu_torch.__all__)
    for name in quattro_tpu_torch.__all__:
        assert hasattr(quattro_tpu_torch, name), name
    assert quattro_tpu_torch.__version__ == quattro_tpu.__version__ == "0.1.0"


def test_root_names_are_the_subpackages_objects():
    for name in quattro_tpu.__all__:
        home = solver if hasattr(solver, name) else models
        assert getattr(quattro_tpu_torch, name) is getattr(home, name), name


def test_checkpoint_locations_follow_jax():
    """The reference's checkpoint directories by their place in its tree, under ``QUATTRO_TPU_REFERENCE``."""
    for name in ("CARTPOLE_CHECKPOINT", "QUADROTOR_CHECKPOINT"):
        theirs = getattr(jtorch_port, name)
        ours = getattr(quattro_tpu_torch, name)
        assert ours is getattr(models, name)
        assert theirs.endswith(os.sep + ours) or ours == theirs
    reference = os.path.dirname(os.path.dirname(os.path.dirname(jtorch_port.CARTPOLE_CHECKPOINT)))
    code = "import quattro_tpu_torch as q; print(q.CARTPOLE_CHECKPOINT); print(q.QUADROTOR_CHECKPOINT)"
    env = dict(os.environ, QUATTRO_TPU_REFERENCE=reference, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, check=True).stdout
    assert out.split() == [jtorch_port.CARTPOLE_CHECKPOINT, jtorch_port.QUADROTOR_CHECKPOINT]


def test_root_import_loads_no_kernel_and_no_jax():
    code = ("import sys, quattro_tpu_torch\n"
            "from quattro_tpu_torch.ops import _build\n"
            "assert not _build._libs and not _build.launches, (_build._libs, _build.launches)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'triton', 'quattro_tpu')]\n"
            "print('LAZY')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and "LAZY" in out.stdout, out.stderr


def test_sim_imports_without_mujoco():
    """The card's machine has no mujoco: ``quattro_tpu_torch.sim`` imports there, a bridge raises ImportError."""
    code = ("import sys\n"
            "sys.modules['mujoco'] = None  # import mujoco now raises ImportError\n"
            "import quattro_tpu_torch.sim as sim\n"
            "try:\n"
            "    sim.CartPoleBridge()\n"
            "except ImportError:\n"
            "    print('RAISED')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and "RAISED" in out.stdout, out.stderr
