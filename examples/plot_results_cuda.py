"""Generate the closed-loop result figures from the PyTorch/CUDA port's simulations.

The counterpart of ``examples/plot_results.py``: it runs the headless MuJoCo
sims of the port (``examples/cartpole_sim_cuda.py``,
``examples/quadrotor_sim_cuda.py``) in pure-iLQR and hybrid (transformer)
modes with the shipped checkpoints, the controllers on ``--device``, and
plots the closed-loop trajectories side by side with the same figure code.
Needs ``mujoco`` (unless ``--no-run``) and ``matplotlib``.

Usage:
    python examples/plot_results_cuda.py --device cpu   # run sims + plot
    python examples/plot_results_cuda.py --no-run       # plot from existing npz logs
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from plot_results import ROOT, plot_cartpole, plot_quadrotor  # noqa: E402  (figure code only: numpy, matplotlib)


def _run(cmd):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT)


def collect(tmp, device):
    cp_ckpt = os.path.join(ROOT, "checkpoints", "cartpole_gain.npz")
    qr_ckpt = os.path.join(ROOT, "checkpoints", "quadrotor_gain.npz")
    py = sys.executable
    dev = ["--device", device]
    _run([py, "examples/cartpole_sim_cuda.py", "--mode", "ilqr", "--steps", "800",
          "--angle", "0.2", "--log", os.path.join(tmp, "cp_ilqr.npz")] + dev)
    _run([py, "examples/cartpole_sim_cuda.py", "--mode", "hybrid", "--steps", "800",
          "--angle", "0.2", "--checkpoint", cp_ckpt,
          "--log", os.path.join(tmp, "cp_hybrid.npz")] + dev)
    _run([py, "examples/quadrotor_sim_cuda.py", "--mode", "ilqr", "--steps", "4000",
          "--z", "0.2", "--roll", "0.1", "--log", os.path.join(tmp, "qr_ilqr.npz")] + dev)
    _run([py, "examples/quadrotor_sim_cuda.py", "--mode", "hybrid", "--steps", "4000",
          "--z", "0.2", "--roll", "0.1", "--checkpoint", qr_ckpt,
          "--log", os.path.join(tmp, "qr_hybrid.npz")] + dev)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--no-run", action="store_true",
                        help="plot from existing npz logs in --tmp")
    parser.add_argument("--tmp", default=os.path.join(tempfile.gettempdir(), "quattro_tpu_torch_sim_logs"))
    parser.add_argument("--out", default=os.path.join(ROOT, "figures", "cuda"))
    parser.add_argument("--device", default="cuda", help="where the sims' controllers run ('cuda', 'cpu')")
    args = parser.parse_args(argv)

    os.makedirs(args.tmp, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    if not args.no_run:
        collect(args.tmp, args.device)
    plot_cartpole(args.tmp, os.path.join(args.out, "cartpole_result.png"))
    plot_quadrotor(args.tmp, os.path.join(args.out, "quadrotor_result.png"))


if __name__ == "__main__":
    main()
