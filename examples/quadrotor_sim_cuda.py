"""Headless quadrotor MPC against the MuJoCo validation plant, on the PyTorch/CUDA port.

The counterpart of ``examples/quadrotor_sim.py``: the solver's model is
parameterized from the COMPILED MuJoCo model's measured mass, inertia and
arm; the plant steps on the host every 1 ms, the port's MPC runs on
``--device`` (default ``cuda``) every ``--decimation`` physics steps, and the
per-step latency is reported. Needs the ``mujoco`` package.

Usage:
    python examples/quadrotor_sim_cuda.py --steps 4000 --z 0.2 --roll 0.1
    python examples/quadrotor_sim_cuda.py --mode hybrid --checkpoint <dir-or-npz> --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cartpole_sim_cuda import load_predictor, require_mujoco  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", default="ilqr", choices=["ilqr", "hybrid"])
    parser.add_argument("--steps", type=int, default=4000, help="physics steps (1 ms each)")
    parser.add_argument("--decimation", type=int, default=20, help="physics steps per MPC step")
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--x", type=float, default=0.0)
    parser.add_argument("--y", type=float, default=0.0)
    parser.add_argument("--z", type=float, default=0.2)
    parser.add_argument("--roll", type=float, default=0.0)
    parser.add_argument("--pitch", type=float, default=0.0)
    parser.add_argument("--yaw", type=float, default=0.0)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--log", default=None)
    parser.add_argument("--device", default="cuda", help="where the controller runs ('cuda', 'cpu')")
    args = parser.parse_args(argv)
    require_mujoco()

    import torch

    from quattro_tpu_torch import resolve_device
    from quattro_tpu_torch.control import make_quadrotor_mpc
    from quattro_tpu_torch.sim import QuadrotorBridge

    dev = resolve_device(args.device)
    plant = QuadrotorBridge()
    print("measured plant params:", plant.solver_params())

    predict_fn = None
    prompt_len = None
    if args.mode == "hybrid" and args.checkpoint:
        predictor = load_predictor(args.checkpoint, dev)
        predict_fn = predictor.predict_fn()
        prompt_len = predictor.prompt_len

    controller = make_quadrotor_mpc(
        horizon=args.horizon,
        mode=args.mode,
        predict_fn=predict_fn,
        prompt_len=prompt_len,
        quad_params=plant.solver_params(),
        device=dev,
    )
    state = controller.init_state()
    plant.reset(position=(args.x, args.y, args.z), rpy=(args.roll, args.pitch, args.yaw))

    x_ref = np.zeros(12)
    x_ref[2] = 0.5

    states, latencies = [], []
    u_host = np.zeros(4)
    mpc_calls = 0
    for step in range(args.steps):
        if step % args.decimation == 0:
            x = plant.read_state()
            t0 = time.perf_counter()
            u, _, state = controller.step(torch.as_tensor(x, dtype=torch.float32, device=dev), state)
            u_host = u.cpu().numpy()
            latencies.append(time.perf_counter() - t0)
            mpc_calls += 1
            plant.apply_thrusts(u_host)
            states.append(x)
            if mpc_calls % 25 == 1:
                print(
                    f"mpc {mpc_calls}: err={np.linalg.norm(x - x_ref):.4f} "
                    f"u={np.round(u_host, 2)} latency={latencies[-1] * 1e3:.2f} ms",
                    flush=True,
                )
        plant.step()

    states = np.asarray(states)
    summary = {
        "final_error": float(np.linalg.norm(states[-1] - x_ref)),
        "mean_latency_ms": float(np.mean(latencies[5:]) * 1e3) if len(latencies) > 5 else None,
        "p99_latency_ms": float(np.percentile(latencies[5:], 99) * 1e3) if len(latencies) > 5 else None,
        "mpc_calls": mpc_calls,
        "mode": args.mode,
        "device": str(dev),
    }
    print(json.dumps(summary))

    if args.log:
        np.savez(args.log, states=states, latencies=np.asarray(latencies))
        print(f"trajectory written to {args.log}")
    return summary


if __name__ == "__main__":
    main()
