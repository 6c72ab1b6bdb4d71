"""Headless cart-pole MPC against the MuJoCo validation plant, on the PyTorch/CUDA port.

The counterpart of ``examples/cartpole_sim.py``: the plant is an independent
MuJoCo model (real model mismatch) stepped on the host, the controller is the
port's MPC on ``--device`` (default ``cuda``). Needs the ``mujoco`` package.
Trajectories are logged to npz for offline inspection.

Usage:
    python examples/cartpole_sim_cuda.py --mode ilqr --steps 1000 --angle 0.2
    python examples/cartpole_sim_cuda.py --mode hybrid --checkpoint <dir-or-npz> --device cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def require_mujoco() -> None:
    """Exit at once, with the reason, where the ``mujoco`` package is missing."""
    if importlib.util.find_spec("mujoco") is None:
        raise SystemExit("this simulation steps a MuJoCo plant and the 'mujoco' package is not installed; "
                         "run it where mujoco is (the controller can stay on the CPU: --device cpu)")


def load_predictor(checkpoint: str, device):
    """A ``GainPredictor`` from an ``.npz`` checkpoint or a reference checkpoint directory."""
    if os.path.isdir(checkpoint):
        from quattro_tpu_torch.models import load_torch_checkpoint

        return load_torch_checkpoint(checkpoint, device=device)
    from quattro_tpu_torch import GainPredictor

    return GainPredictor.load(checkpoint, device=device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", default="ilqr", choices=["ilqr", "hybrid", "lqr", "blend"])
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--horizon", type=int, default=30)
    parser.add_argument("--position", type=float, default=0.0)
    parser.add_argument("--angle", type=float, default=0.2)
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="GainPredictor npz, or a reference torch checkpoint directory",
    )
    parser.add_argument("--log", default=None, help="npz output path for the trajectory")
    parser.add_argument("--device", default="cuda", help="where the controller runs ('cuda', 'cpu')")
    args = parser.parse_args(argv)
    require_mujoco()

    import torch

    from quattro_tpu_torch import resolve_device
    from quattro_tpu_torch.control import make_cartpole_mpc
    from quattro_tpu_torch.sim import CartPoleBridge

    dev = resolve_device(args.device)
    predict_fn = None
    prompt_len = None
    if args.mode in ("hybrid", "blend") and args.checkpoint:
        predictor = load_predictor(args.checkpoint, dev)
        predict_fn = predictor.predict_fn()
        prompt_len = predictor.prompt_len

    controller = make_cartpole_mpc(
        horizon=args.horizon, mode=args.mode, predict_fn=predict_fn, prompt_len=prompt_len, device=dev
    )
    state = controller.init_state()

    plant = CartPoleBridge()
    plant.reset(position=args.position, angle=args.angle)

    states, controls, latencies = [], [], []
    for step in range(args.steps):
        x = plant.read_state()
        t0 = time.perf_counter()
        u, _, state = controller.step(torch.as_tensor(x, dtype=torch.float32, device=dev), state)
        u_host = float(u.cpu()[0])
        latencies.append(time.perf_counter() - t0)
        plant.apply_control(u_host)
        plant.step()
        states.append(x)
        controls.append(u_host)
        if step % 200 == 0:
            print(
                f"step {step}: |x|={np.linalg.norm(x):.4f} u={u_host:+.3f} "
                f"latency={latencies[-1] * 1e3:.2f} ms",
                flush=True,
            )

    states = np.asarray(states)
    summary = {
        "final_state_norm": float(np.linalg.norm(states[-1])),
        "mean_latency_ms": float(np.mean(latencies[10:]) * 1e3) if len(latencies) > 10 else None,
        "p99_latency_ms": float(np.percentile(latencies[10:], 99) * 1e3) if len(latencies) > 10 else None,
        "steps": args.steps,
        "mode": args.mode,
        "device": str(dev),
    }
    print(json.dumps(summary))

    if args.log:
        np.savez(args.log, states=states, controls=np.asarray(controls), latencies=np.asarray(latencies))
        print(f"trajectory written to {args.log}")
    return summary


if __name__ == "__main__":
    main()
