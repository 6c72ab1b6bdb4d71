"""Collect gain-prediction training data and fit the transformer, end to end, on the PyTorch/CUDA port.

The counterpart of ``examples/collect_and_train.py`` with the same arguments
and defaults, plus ``--device`` (default ``cuda``): closed-loop MPC sweeps
through the logged batched solve (one batched Riccati launch per trip on the
card) become training rows, and the port's Adam trainer fits the
``GainPredictor`` on them. The checkpoint is the self-describing ``.npz``
that both packages' ``GainPredictor.load`` read.

Usage:
    python examples/collect_and_train_cuda.py --system cartpole \\
        --num-inits 64 --sim-steps 100 --epochs 60 --out cartpole_gain.npz
    python examples/collect_and_train_cuda.py --system quadrotor --plant model \\
        --quad-params nominal --device-resident --out quadrotor_gain.npz

``--plant mujoco`` and ``--quad-params measured`` need the ``mujoco``
package; without it ``measured`` falls back to the nominal vehicle, loudly.
``main(argv)`` runs the program in process and returns its summary.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def cartpole_setup(horizon, device="cuda", dtype=None):
    """(dynamics, running cost, final cost, n, m) of the cart-pole collection."""
    import torch

    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import CartPoleField, make_discrete

    dtype = dtype or torch.float32
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    x_ref = torch.zeros(4, dtype=dtype, device=device)
    table = functools.partial(torch.tensor, dtype=torch.float64)  # cast once, to x_ref's dtype
    cost = make_quadratic_cost(table([5.0, 0.1, 10.0, 0.1]), table([0.001]), x_ref)
    fcost = make_quadratic_final_cost(table([50.0, 6.0, 100.0, 0.1]), x_ref)
    return dyn, cost, fcost, 4, 1


def quadrotor_setup(horizon, device="cuda", dtype=None):
    """(dynamics, running cost with the thrust barrier, final cost, n, m) of the quadrotor collection."""
    import torch

    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    dtype = dtype or torch.float32
    dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
    x_ref = torch.zeros(12, dtype=dtype, device=device)
    x_ref[2] = 0.5
    table = functools.partial(torch.tensor, dtype=torch.float64)  # cast once, to x_ref's dtype
    q = table([10.0, 10.0, 50.0, 1, 1, 1, 10.0, 10.0, 50.0, 1, 1, 1])
    qf = table([100.0, 100.0, 500.0, 10, 10, 10, 100.0, 100.0, 500.0, 10, 10, 10])
    cost = make_quadratic_cost(q, table([0.01] * 4), x_ref, barrier_alpha=1000.0)
    fcost = make_quadratic_final_cost(qf, x_ref)
    return dyn, cost, fcost, 12, 4


# Quadrotor LHS pose envelopes (x, y, z, roll, pitch, yaw): "reference" is the
# reference's near-hover collection envelope (the shipped 616.2k checkpoint's
# training distribution), "wide" this repo's broader one.
QUAD_ENVELOPES = {
    "reference": ((-0.3, -0.3, 0.49, -0.2, -0.2, -0.5),
                  (0.3, 0.3, 0.51, 0.2, 0.2, 0.5)),
    "wide": ((-0.5, -0.5, 0.1, -0.3, -0.3, -0.3),
             (0.5, 0.5, 0.9, 0.3, 0.3, 0.3)),
}


def initial_states(system, num, generator, envelope="wide", device="cuda"):
    """float32 initial states on ``device``: the cart-pole's deterministic grid of
    positions x angles in [-0.5, 0.5], or a Latin hypercube over the quadrotor's
    pose envelope drawn from ``generator`` (in float64 on the generator's device)."""
    import torch

    from quattro_tpu_torch.training import lhs_initial_states

    if system == "cartpole":
        side = int(np.ceil(np.sqrt(num)))
        pos = np.linspace(-0.5, 0.5, side)
        ang = np.linspace(-0.5, 0.5, side)
        grid = np.stack(np.meshgrid(pos, ang), axis=-1).reshape(-1, 2)[:num]
        x0 = np.zeros((num, 4))
        x0[:, 0] = grid[:, 0]
        x0[:, 2] = grid[:, 1]
        return torch.as_tensor(x0, dtype=torch.float32, device=device)

    lo, hi = QUAD_ENVELOPES[envelope]
    lower = torch.tensor(lo, dtype=torch.float64, device=generator.device)
    upper = torch.tensor(hi, dtype=torch.float64, device=generator.device)
    pose = lhs_initial_states(generator, lower, upper, num)  # x, y, z, roll, pitch, yaw
    x0 = torch.zeros((num, 12), dtype=torch.float64, device=generator.device)
    x0[:, 0:3] = pose[:, 0:3]
    x0[:, 6:9] = pose[:, 3:6]
    return x0.to(device=device, dtype=torch.float32)


def _quadrotor_reset(bridge):
    return lambda x0: bridge.reset(position=(float(x0[0]), -float(x0[1]), float(x0[2])),
                                   rpy=(float(x0[6]), float(x0[7]), float(x0[8])))


def mujoco_plant_adapters(system):
    """(reset_fn, read_fn, apply_fn, step_fn, substeps, solver params) for
    host-loop collection against the MuJoCo plant (model mismatch included)."""
    from quattro_tpu_torch.sim import CartPoleBridge, QuadrotorBridge

    if system == "cartpole":
        bridge = CartPoleBridge()

        def reset_fn(x0):
            bridge.reset(position=float(x0[0]), angle=float(x0[2]))

        def apply_fn(u):
            bridge.apply_control(float(u[0]))

        return reset_fn, bridge.read_state, apply_fn, bridge.step, 1, None

    bridge = QuadrotorBridge()
    return (_quadrotor_reset(bridge), bridge.read_state, bridge.apply_thrusts, bridge.step,
            20, bridge.solver_params())


def mujoco_plant_adapters_batched(system, count):
    """``count`` independent plant adapter tuples for the lockstep batched
    host-loop collector (one MuJoCo instance per lane), plus (substeps,
    measured params)."""
    from quattro_tpu_torch.sim import CartPoleBridge, QuadrotorBridge

    plants = []
    if system == "cartpole":
        for _ in range(count):
            b = CartPoleBridge()
            plants.append((
                lambda x0, b=b: b.reset(position=float(x0[0]), angle=float(x0[2])),
                b.read_state,
                lambda u, b=b: b.apply_control(float(u[0])),
                b.step,
            ))
        return plants, 1, None
    measured = None
    for _ in range(count):
        b = QuadrotorBridge()
        measured = b.solver_params()
        plants.append((_quadrotor_reset(b), b.read_state, b.apply_thrusts, b.step))
    return plants, 20, measured


def make_dagger_policy(dyn, cost, fcost, predictor, tol, x_ref, state_offset):
    """The RAW hybrid MPC of ``predictor`` as a batched policy ``(x (P, n), u_warm (P, H, m)) -> (u0, u_warm')``.

    JAX's example maps ``hybrid_ilqr_solve`` over the lanes with ``jax.vmap``;
    here ``batched_hybrid_ilqr_solve`` solves them together, one call per
    control step (one K4 launch over the lanes' tail windows per trip on the
    card), each lane's answer that lane's single solve.
    """
    from torch.func import vmap

    from quattro_tpu_torch.control import shift_warm_start
    from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve
    from quattro_tpu_torch.solver import ILQRConfig

    # Deployment-matched: exact_fallback=False, deployment tol and max_iter.
    config = ILQRConfig(tol=tol, max_iter=100)
    predict_fn = predictor.predict_fn()

    def policy(xb, uwb):
        sol = batched_hybrid_ilqr_solve(dyn, cost, fcost, predict_fn, predictor.prompt_len, xb, uwb, x_ref, config,
                                        state_offset=state_offset, exact_fallback=False)
        return sol.u_seq[:, 0], vmap(shift_warm_start)(sol.u_seq)

    return policy


def _drop_nonfinite_rows(dataset):
    """Drop rows with non-finite states or gain labels (host ``GainDataset``).

    One NaN row (e.g. labels solved on a diverged on-policy DAgger lane)
    makes every feature of the z-score normalizer NaN, and the training run
    with it. Applied to every host dataset right before training.
    """
    from quattro_tpu_torch.training import GainDataset

    if not isinstance(dataset, GainDataset):
        return dataset
    finite = (np.isfinite(dataset.x_data).all(axis=(1, 2))
              & np.isfinite(dataset.kk_data).all(axis=(1, 2)))
    if not finite.all():
        print(f"dropping {int((~finite).sum())} non-finite rows", flush=True)
        dataset = GainDataset(dataset.x_data[finite], dataset.kk_data[finite])
    return dataset


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--system", required=True, choices=["cartpole", "quadrotor"])
    parser.add_argument("--plant", default="model",
                        choices=["model", "mujoco", "randomized"],
                        help="'model': batched on-device sweeps against the solver's own "
                             "dynamics; 'mujoco': host-loop closed-loop collection against "
                             "the MuJoCo plant (the model-mismatch distribution); "
                             "'randomized': on-device domain randomization, every "
                             "trajectory's plant with independently perturbed physical "
                             "parameters (--plant-rel), the solver on the nominal model")
    parser.add_argument("--plant-rel", type=float, default=0.1,
                        help="relative parameter-perturbation range for --plant randomized")
    parser.add_argument("--horizon", type=int, default=None)
    parser.add_argument("--prompt-len", type=int, default=None)
    parser.add_argument("--num-inits", type=int, default=64)
    parser.add_argument("--envelope", default="wide", choices=sorted(QUAD_ENVELOPES),
                        help="quadrotor initial-pose LHS bounds: 'reference' = the "
                             "reference's near-hover collection envelope, 'wide' = this "
                             "repo's broader envelope (cart-pole ignores this)")
    parser.add_argument("--sim-steps", type=int, default=100)
    parser.add_argument("--parallel-plants", type=int, default=0,
                        help="with --plant mujoco: run this many MuJoCo instances "
                             "in lockstep with one batched solve per control step; "
                             "0 = sequential host loop")
    parser.add_argument("--max-iter", type=int, default=8)
    parser.add_argument("--dagger-checkpoint", default=None,
                        help="with --plant mujoco --parallel-plants: drive the "
                             "plants with this checkpoint's RAW hybrid MPC "
                             "(DAgger-style on-policy collection; rows still "
                             "labeled by the exact solver)")
    parser.add_argument("--compact-iters", type=int, default=None,
                        help="on-device valid-row compaction cap (mean accepted "
                             "iterations per MPC step) for --plant model/randomized; "
                             "bounds the device->host transfer")
    parser.add_argument("--device-resident", action="store_true",
                        help="keep the dataset in device memory end to end (collection "
                             "rows never cross to the host; the trainer gathers its "
                             "minibatches on the device). Implies --compact-iters "
                             "(default 3); incompatible with --plant mujoco and --dataset-out")
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="mid-training checkpoint/resume directory (long runs survive a crash)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--lr-schedule", default="constant",
                        choices=["constant", "cosine"],
                        help="'constant' = the reference's fixed-lr Adam; 'cosine' "
                             "decays to ~0 over the run (large-dataset runs)")
    parser.add_argument("--patience", type=int, default=5,
                        help="early-stop patience on test loss; >= --epochs "
                             "disables early stopping")
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--nhead", type=int, default=4)
    parser.add_argument("--layers", type=int, default=3)
    parser.add_argument("--ff", type=int, default=None)
    parser.add_argument("--max-seq-len", type=int, default=None,
                        help="transformer position budget; defaults to the per-system "
                             "reference value, or 2*horizon+16 for non-default horizons")
    parser.add_argument("--tol", type=float, default=None)
    parser.add_argument("--state-stride", type=int, default=1,
                        help="subsample the state context by this stride (long horizons)")
    parser.add_argument("--quad-params", default="measured",
                        choices=["measured", "nominal"],
                        help="quadrotor physical parameters for the solver model and "
                             "the randomization center in --plant model/randomized. "
                             "'measured' (default) reads mass/inertia/arm from the "
                             "compiled MuJoCo plant, as the closed-loop sims do; "
                             "'nominal' is the textbook vehicle (mass 1.0, arm 0.1). "
                             "Falls back to nominal (loudly) if MuJoCo is unavailable")
    parser.add_argument("--out", required=True, help="output GainPredictor npz path")
    parser.add_argument("--dataset-out", default=None,
                        help="optional dataset dump: .qtshard (validated shards) or .npz")
    parser.add_argument("--dataset-in", default=None, nargs="+",
                        help="skip collection; train from saved dataset file(s)")
    parser.add_argument("--max-rows", type=int, default=None,
                        help="random row subsample cap after loading (device-memory "
                             "budget of the device-resident trainer)")
    parser.add_argument("--device", default="cuda",
                        help="where the solves and the training run ('cuda', 'cuda:1', 'cpu')")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the program on ``argv`` (default ``sys.argv[1:]``); returns the summary it prints last."""
    args = build_parser().parse_args(argv)

    if args.dagger_checkpoint and not (args.plant == "mujoco" and args.parallel_plants):
        raise SystemExit("--dagger-checkpoint requires --plant mujoco with "
                         "--parallel-plants N (the batched lockstep collector "
                         "is the only policy-driven path)")
    if args.device_resident:
        if args.plant == "mujoco" and not args.parallel_plants:
            raise SystemExit("--device-resident requires an on-device plant "
                             "(--plant model/randomized) or the batched mujoco "
                             "host loop (--parallel-plants N, whose host rows "
                             "are uploaded flat for device-resident training)")
        if args.dataset_out and args.plant != "mujoco":
            raise SystemExit("--device-resident keeps rows on the device; --dataset-out "
                             "would force the full transfer this mode exists to avoid")
        if args.compact_iters is None:
            args.compact_iters = 3

    import torch

    from quattro_tpu_torch import resolve_device
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.solver import ILQRConfig
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete
    from quattro_tpu_torch.training import (
        GainDataset, TrainConfig, collect_gain_dataset, train_gain_predictor,
    )

    dev = resolve_device(args.device)

    # Reference hyperparameter defaults per system.
    if args.system == "cartpole":
        horizon = args.horizon or 30
        prompt_len = args.prompt_len or 5
        ff = args.ff or 256
        max_seq_len = 100
        tol = 1e-1
        setup = cartpole_setup
    else:
        horizon = args.horizon or 50
        prompt_len = args.prompt_len or 1
        ff = args.ff or 512
        max_seq_len = 110
        tol = 1e-3
        setup = quadrotor_setup
    # Token budget: (H+1) state rows + prompt_len + (H - prompt_len) targets
    # = 2H+1 tokens; longer horizons than the reference's get a derived budget.
    if args.max_seq_len is not None:
        max_seq_len = args.max_seq_len
    elif 2 * horizon + 1 > max_seq_len:
        max_seq_len = 2 * horizon + 16
    if args.tol is not None:
        tol = args.tol

    dyn, cost, fcost, n, m = setup(horizon, dev)

    # Parameter-match the quadrotor solver model (and the randomization
    # center) to the compiled MuJoCo plant, as the closed-loop sims do.
    quad_center = None
    if args.system == "quadrotor" and args.plant in ("model", "randomized"):
        if args.quad_params == "measured":
            try:
                from quattro_tpu_torch.sim import QuadrotorBridge

                quad_center = QuadrotorBridge().solver_params()
            except Exception as exc:  # mujoco-less hosts
                print(f"WARNING: --quad-params measured unavailable ({exc}); "
                      f"falling back to nominal", flush=True)
        if quad_center is not None:
            dyn = make_discrete(QuadrotorField(quad_center), 0.01, "rk4")
            print(f"solver model parameter-matched to MuJoCo: {quad_center}", flush=True)

    x0s = initial_states(args.system, args.num_inits, torch.Generator().manual_seed(0),
                         envelope=args.envelope, device=dev)

    t0 = time.time()
    solve_config = ILQRConfig(tol=tol, max_iter=args.max_iter)
    if args.dataset_in:
        from quattro_tpu_torch.training import load_gain_dataset

        dataset = load_gain_dataset(args.dataset_in)
        print(f"loaded {dataset.x_data.shape[0]} rows from {args.dataset_in}", flush=True)
        dataset = _drop_nonfinite_rows(dataset)
        if args.max_rows and dataset.x_data.shape[0] > args.max_rows:
            sel = np.random.default_rng(7).choice(
                dataset.x_data.shape[0], args.max_rows, replace=False
            )
            dataset = GainDataset(dataset.x_data[sel], dataset.kk_data[sel])
            print(f"subsampled to {args.max_rows} rows (--max-rows)", flush=True)
    elif args.plant == "mujoco" and args.parallel_plants:
        from quattro_tpu_torch.training import collect_gain_dataset_host_batched

        plants, substeps, measured = mujoco_plant_adapters_batched(args.system, args.parallel_plants)
        print(f"collecting (mujoco plant, {args.parallel_plants} lockstep lanes): "
              f"{args.num_inits} inits x {args.sim_steps} MPC steps x <= "
              f"{args.max_iter} iLQR iters (horizon {horizon})", flush=True)
        if measured is not None:
            dyn = make_discrete(QuadrotorField(measured), 0.01, "rk4")
        policy = None
        if args.dagger_checkpoint:
            dag_pred = GainPredictor.load(args.dagger_checkpoint, device=dev)
            x_ref_pol = torch.zeros(n, device=dev)
            offset_pol = torch.zeros(n, device=dev)
            if args.system == "quadrotor":
                x_ref_pol[2] = 0.5
                offset_pol[2] = 0.5
            policy = make_dagger_policy(dyn, cost, fcost, dag_pred, tol, x_ref_pol, offset_pol)
            print(f"DAgger policy: RAW hybrid from {args.dagger_checkpoint}", flush=True)
        dataset = collect_gain_dataset_host_batched(
            plants, dyn, cost, fcost, x0s.cpu().numpy(), horizon, m, args.sim_steps,
            config=solve_config, substeps=substeps,
            compact_iters=args.compact_iters or 3,
            shard_path=args.dataset_out
            if args.dataset_out and args.dataset_out.endswith(".qtshard") else None,
            policy=policy, verbose=True, device=dev,
        )
    elif args.plant == "mujoco":
        from quattro_tpu_torch.training import collect_gain_dataset_host

        reset_fn, read_fn, apply_fn, step_fn, substeps, measured = mujoco_plant_adapters(args.system)
        print(f"collecting (mujoco plant): {args.num_inits} inits x {args.sim_steps} "
              f"MPC steps x <= {args.max_iter} iLQR iters (horizon {horizon})", flush=True)
        if measured is not None:
            dyn = make_discrete(QuadrotorField(measured), 0.01, "rk4")
        dataset = collect_gain_dataset_host(
            reset_fn, read_fn, apply_fn, step_fn, dyn, cost, fcost,
            x0s.cpu().numpy(), horizon, m, args.sim_steps, config=solve_config,
            substeps=substeps, shard_path=args.dataset_out
            if args.dataset_out and args.dataset_out.endswith(".qtshard") else None,
            verbose=True, device=dev,
        )
    elif args.plant == "randomized":
        from quattro_tpu_torch.systems import (
            CartPoleParams, QuadrotorParams, cartpole_dynamics, quadrotor_dynamics, rk4_step,
        )
        from quattro_tpu_torch.training import perturb_params

        cont = cartpole_dynamics if args.system == "cartpole" else quadrotor_dynamics
        if args.system == "cartpole":
            nominal = CartPoleParams()
        else:
            nominal = quad_center if quad_center is not None else QuadrotorParams()

        def plant(x, u, theta):
            return rk4_step(lambda xx, uu: cont(xx, uu, theta), x, u, 0.01)

        theta_batch = perturb_params(torch.Generator().manual_seed(7), nominal, args.plant_rel,
                                     args.num_inits, device=dev)
        print(f"collecting (randomized plant, rel={args.plant_rel}): {args.num_inits} "
              f"inits x {args.sim_steps} MPC steps x <= {args.max_iter} iLQR iters "
              f"(horizon {horizon})", flush=True)
        dataset = collect_gain_dataset(
            dyn, cost, fcost, x0s, horizon, m, args.sim_steps, config=solve_config,
            plant_dynamics=plant, plant_params_batch=theta_batch,
            compact_iters=args.compact_iters,
            device_resident=args.device_resident, verbose=True,
        )
    else:
        print(f"collecting (model plant): {args.num_inits} inits x {args.sim_steps} "
              f"MPC steps x <= {args.max_iter} iLQR iters (horizon {horizon})", flush=True)
        dataset = collect_gain_dataset(
            dyn, cost, fcost, x0s, horizon, m, args.sim_steps, config=solve_config,
            compact_iters=args.compact_iters,
            device_resident=args.device_resident, verbose=True,
        )
    collect_s = time.time() - t0
    print(f"collected {dataset.x_data.shape[0]} rows in {collect_s:.1f}s", flush=True)
    stats = getattr(dataset, "stats", None)
    if stats is not None:
        print(f"row accounting: kept {stats.rows_kept}/{stats.rows_valid} valid "
              f"(dropped fraction {stats.dropped_fraction:.4f})", flush=True)
        if stats.dropped_fraction > 0.01:
            print("WARNING: >1% of valid rows dropped by the compaction cap; "
                  "raise --compact-iters (data is skewed toward easy steps)",
                  flush=True)
    if args.dataset_out and not args.dataset_in and not (
            args.plant == "mujoco" and args.dataset_out.endswith(".qtshard")):
        from quattro_tpu_torch.training import save_gain_dataset

        save_gain_dataset(args.dataset_out, dataset)

    summary = {
        "rows": int(dataset.x_data.shape[0]),
        "rows_valid": stats.rows_valid if stats is not None else None,
        "rows_dropped": stats.rows_dropped if stats is not None else None,
        "dropped_fraction": stats.dropped_fraction if stats is not None else None,
        # Trips of the logged batched solve; the host-loop collectors do not count them.
        "trips": stats.trips if stats is not None and args.plant != "mujoco" else None,
        "collect_s": collect_s,
    }
    if args.epochs == 0:
        print("epochs=0: collection-only run, skipping training", flush=True)
        print(json.dumps(summary))
        return summary

    # Every host dataset passes the finite-row filter before normalization.
    dataset = _drop_nonfinite_rows(dataset)

    # 80/20 split, shuffled with a fixed seed.
    if args.device_resident and isinstance(dataset, GainDataset):
        # Batched-mujoco rows land on the host: split there, then upload each split once in the flat layout.
        from quattro_tpu_torch.training import DeviceGainDataset

        rng = np.random.default_rng(42)
        perm = rng.permutation(dataset.x_data.shape[0])
        split = int(len(perm) * 0.8)
        train = DeviceGainDataset.from_host(
            GainDataset(dataset.x_data[perm[:split]], dataset.kk_data[perm[:split]]), device=dev
        )
        test = DeviceGainDataset.from_host(
            GainDataset(dataset.x_data[perm[split:]], dataset.kk_data[perm[split:]]), device=dev
        )
    elif args.device_resident:
        train, test = dataset.split(0.8, seed=42)
    else:
        rng = np.random.default_rng(42)
        perm = rng.permutation(dataset.x_data.shape[0])
        split = int(len(perm) * 0.8)
        train = GainDataset(dataset.x_data[perm[:split]], dataset.kk_data[perm[:split]])
        test = GainDataset(dataset.x_data[perm[split:]], dataset.kk_data[perm[split:]])

    predictor = GainPredictor.create(
        state_dim=n,
        control_dim=m * (1 + n),
        prompt_len=prompt_len,
        target_len=horizon - prompt_len,
        d_model=args.d_model,
        nhead=args.nhead,
        num_decoder_layers=args.layers,
        dim_feedforward=ff,
        max_seq_len=max_seq_len,
        generator=torch.Generator().manual_seed(0),
        state_stride=args.state_stride,
        device=dev,
    )
    print(f"training {predictor.num_params():,}-param model "
          f"({args.epochs} epochs, batch {args.batch_size})", flush=True)
    t0 = time.time()
    result = train_gain_predictor(
        predictor, train, test,
        TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                    learning_rate=args.learning_rate, patience=args.patience,
                    lr_schedule=args.lr_schedule,
                    checkpoint_dir=args.checkpoint_dir, verbose=True),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0
    print(f"trained in {train_s:.1f}s", flush=True)

    result.predictor.save(args.out)
    rows_train = len(train) if not isinstance(train, GainDataset) else train.x_data.shape[0]
    summary.update({
        "params": int(result.predictor.num_params()),
        "train_rows": int(rows_train),
        "train_steps": len(result.train_loss_history) * max(rows_train // min(args.batch_size, rows_train), 1),
        "train_s": train_s,
        "final_train_loss": float(result.train_loss_history[-1]) if len(result.train_loss_history) else None,
        "final_test_loss": float(result.test_loss_history[-1]) if len(result.test_loss_history) else None,
        "checkpoint": args.out,
    })
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
