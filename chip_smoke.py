#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (quattro_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Build the eight CUDA sources (K1-K9) from ``quattro_tpu_torch/csrc`` (one nvcc each, in parallel).
2. K1 (fused Riccati) against its plain PyTorch form on the card, on the
   bench problem's stages (H=100, n=12, m=4), float64 and float32; timed in
   float32 at H=50, 100 (bench stages) and 1,024 (the suite's random LQ
   problem): the call, and the device time queued behind a sleep kernel, per
   step beside the byte bound per step.
3. K2 (fused all-alpha rollouts) against its plain form, quadrotor RK4,
   H=100, A=6, and cart-pole RK4, H=30, float64 and float32; and as the
   megakernel path uses it, the initial rollout of a warm start (one
   candidate, zero gains; quadrotor H=50, cart-pole H=30) against ``simulate``.
   Timed in float32 at H=50, 100 and 1,024: the call, and the device time
   queued behind a sleep kernel, per step beside the bound per step.
4. The bench problem (quadrotor RK4 hover, H=100, 6 forced iterations)
   through K1 + K2, held to the same solve with riccati="seq",
   linesearch="xla"; iterations/s of both.
5. Quadrotor MPC at H=50 (``make_quadrotor_mpc``, whose solves run K1 and
   K2 on the card), closed loop from z=0.2, roll=0.15 against the port's RK4
   plant: pure iLQR, 300 steps, ||x - x_ref|| < 0.05 at the end; then hybrid
   with the shipped gain predictor (checkpoints/quadrotor_gain.npz), 100
   steps, held to the pure loop's state at the same step.
   Before the closed loops, the wall time of each part of one solve
   iteration at H=50 (simulate, derivatives, both Riccati forms, both line
   searches, the predictor) is printed as one ``breakdown_ms`` line; after
   each, the device idle share of the next 3 steps under torch.profiler.

6. K3 (the whole solve in one launch) against its plain form: quadrotor at
   H=50 (the MPC shape) and H=100 (the bench problem), cart-pole at H=30;
   float64 and float32; forced trips (tol=0) and a run that converges before
   its last trip; ``iters`` and ``converged`` equal, x, u, k, K and cost
   within the bounds below. Forced runs are timed: the call, and the device
   time of the bare C entry point queued behind a sleep kernel, per time step
   per trip.
7. The megakernel MPC path at full width: ``make_quadrotor_mpc(horizon=50,
   solver="megakernel", max_iter=6)``, 300 closed-loop steps, the same error
   bar, exactly one K3 launch per step, step latency and device idle share;
   the same step with ``simulate`` as the initial rollout, for its latency.
   Then ``make_cartpole_mpc`` from [0.15, 0, 0.2, 0] with
   ``solver="megakernel"`` and in mode ``"blend"`` (K1, K2 and the LQR gain).
8. The batched kernels (run after phase 6), on a warm-started batch of
   ``benchmarks/suite.py``'s problem (quadrotor RK4, H=50) at B=512 and 2048,
   float64 and float32: K4 on its column-major, batch2d, auto and packed
   entry points against its plain form, lane by lane against K1 (bit for
   bit), and with a bfloat16 stage stream (against its plain form, and
   within 5e-2 of float32); K5 (B=2048, tile_s=8) against its plain form on
   the packed tensors, and K5 -> K4 (packed) against K4 on the unpacked
   stages (bit for bit); K6 and K7 (A=6) against their plain form and lane
   by lane against K2 (bit for bit), timed in float32 at B=512 and 2048 (the
   call, and the device time queued behind a sleep kernel). K4 is timed on its
   natural, packed and bf16 inputs (its kernels-line entry carries all three,
   and the device time on contiguous natural stages: the natural call copies
   the strided stages of vmap's Jacobians first), K5 in float32 and float64.
9. ``batched_ilqr_solve`` at the suite's problem (x0 z in [0.2, 0.5], zero
   controls, 4 forced iterations): backends "fused" (PyTorch line search, and
   linesearch="fused" through K7), "fused_bf16" and "vmap", float32 at
   B=512 and 2048 and float64 at B=512. One K4 launch per trip (and one K7
   with linesearch="fused"); float64 "fused" equals "vmap" (iterations,
   flags, cost rtol 1e-9, u atol 1e-8); solves/s of a warm call each.
10. One fully fused batched trip through public entry points, K5 -> K4
   (packed) -> ``line_search_batched2d`` (K6), held to the "fused" backend's
   first trip, with the device idle share of that trip and the summed device
   time of its three kernels (each queued behind a sleep kernel).
11. K8 (batched SPD solve, run after phase 8) against its plain form at
   ``benchmarks/suite.py``'s shapes (m=4, r=13, B=301, 65,536 and 1,048,576;
   float64 at 65,536) and the main path's widest launch (102,400 systems,
   r=25 and 13), timed beside ``torch.linalg.solve``; K9 (block-tridiagonal
   SpMV) and its fused ``kkt_residual`` against their plain forms at N=1,024
   and 131,072 (n=12, both dtypes), timed beside one ``torch.bmm`` of the
   stacked band. Each timed shape prints the call time (CUDA events around
   the public function, in turns with the library call), the device time of
   the bare C entry point on prepared pointers and of the library call (both
   queued behind a sleep kernel, so the device runs them back to back), and
   the share of the bound. No profiler session: one slows the host's later
   launches in its process, and later phases are bound by the host.
12. The associative Riccati form (run last): the pass in float64 on the card
   against the CPU and against K1 (bench stages H=100, the suite's random LQ
   problem H=1024; exactly 2 K8 launches per pass), timed in float32 at H=50,
   100, 1024 beside K1 and the sequential form; ``ilqr_solve(riccati="assoc")``
   on the bench problem against the CPU run; a 20-step
   ``make_quadrotor_mpc(riccati="assoc")`` loop held to the pure loop of
   phase 5; ``batched_ilqr_solve`` ("vmap", assoc) at B=512 and 2048 (2 K8
   launches per trip; float64 lanes against their single solves); and the KKT
   route (``build_lqr_kkt`` -> ``btd_solve`` -> ``recover_primal`` ->
   ``kkt_residual``, K9) on both problems against K1's Newton step and the CPU.
13. The training path (``phase_train``): ``collect_gain_dataset`` on the
   quadrotor (RK4, H=50, the example collection's cost, ILQRConfig(tol=1e-3,
   max_iter=8, linesearch="fused")) from 1,024 LHS initial states over 10
   MPC steps, device-resident with compact_iters=3, float32: one K4 and one
   K7 launch per trip of the logged batched solve, rows kept/valid/dropped
   and rows/s; the same collection at B=64 over 3 steps in float64 with the
   fused and "vmap" backends (equal valid masks and rows, x within 1e-8 and
   gain tokens within 1e-7); the shipped quadrotor predictor's width (616,244
   parameters) trained 2 epochs (batch 256, cosine) on the device-resident
   and in-memory paths, the loss falling on both; 5 Adam steps on the card
   against the CPU (dropout 0, per-step loss within 1e-4); the trained
   predictor's hybrid MPC over 10 steps held to the pure loop of phase 5
   (1e-3); the device idle share of a training epoch and of a control step's
   collection, and the peak device memory. The shard IO's native library
   must be the active backend.

14. The mesh path (``phase_mesh``), on virtual meshes that name the one card once per shard: ``make_mesh()``
   (every visible card); ``sharded_ilqr_solve`` at phase 9's problem, B=2048 on an (8, 1) mesh, float32,
   ``linesearch="fused"`` (K4 and K7 once per trip of each shard: 32 each), every lane held to
   ``batched_ilqr_solve`` at B=2048, solves/s of both; float64 at B=512 on (4, 1) against the unsharded solve
   (iterations, flags, cost rtol 1e-8, u atol 1e-8); ``sharded_riccati_backward`` on the random LQ problem at
   H=1,024 on a (1, 8) mesh, tree and ring, float64 against the CPU run (1e-9) and K1 (the JAX test's
   tolerances), one K8 and one K1 launch per shard and the halo hops of ``halo_schedule_spec``, float32 ms per
   pass beside K1 and the associative pass; ``podscale_riccati_backward`` at B=4,096, H=1,024, float32 on a
   (2, 4) mesh against K4 on the same stages (and K1 on three lanes), two K8 launches per shard, ms per pass
   and peak memory, float64 at B=64, H=256 against the CPU run; ``verify_halo_exchange`` (0.0 clean, 1.0
   after one flipped bit); and 5 Adam steps of the shipped predictor's width with ``mesh=`` over a (4,) mesh
   against ``mesh=None`` (dropout 0, TF32 off, losses within 1e-5 relative).

15. The examples (``phase_examples``): ``examples/collect_and_train_cuda.py``'s ``main`` called in process at
   the JAX example's model width (d_model 128, 4 heads, 3 layers, ff 512: 616,244 parameters for the
   quadrotor) and its default 64 initial states and 8 iterations, three runs: quadrotor with the model plant
   (nominal parameters, device-resident, 10 MPC steps, 2 epochs, checkpoint written), quadrotor with the
   randomized plant (5 steps, collection only), cart-pole with the model plant (10 steps, 1 epoch). Exactly
   one K4 launch per trip of each collection (the example's linesearch="xla": no K7). The quadrotor
   checkpoint, loaded through the package root's ``GainPredictor.load``, drives 20 steps of the hybrid MPC
   (K1 and K2), held to the pure loop of phase 5 (1e-3).

16. The batched hybrid solve (``phase_hybrid``): ``benchmarks/suite.py``'s ``bench_hybrid_speedup_batched``
   problem (quadrotor RK4, B=64, ``ILQRConfig(tol=0, max_iter=4, linesearch="fused")``, x0 z = 0.2 + 0.3 U
   from a numpy seed, x0[6] = 0.1, zero controls) at H=256 with ``checkpoints/quadrotor_h256_gain.npz`` and at
   H=512 with ``quadrotor_h512_gain.npz``, float32: the pure fused batched solve (K4 + K7 per trip) and
   ``batched_hybrid_ilqr_solve`` (K4 over the 16-step tail window, one predictor forward over the batch, K7
   per trip), launches equal to the trips, ms per iteration of each (median of 3 synchronized calls, in
   turns), the device idle share of one hybrid call, and the host-side split of a trip (derivatives, K4,
   predictor, K7, select); at H=256 every float32 lane held to its single ``hybrid_ilqr_solve`` (cost rtol
   1e-4; the single solves run in 4 worker processes beside the float64 runs below). Then float64, B=8 (4 of
   the suite's lanes, 4 near the hover), ``max_iter=3``, tol 0.1: with and without the exact fallback (its
   backward pass forced to K4), at H=256 (window 16) and H=50 with ``quadrotor_gain.npz`` (window 1), every
   lane equal to its single solve on the card (iterations and flags, cost rtol 1e-9, u atol 1e-8); and the
   fallback in float32 under ``riccati_backend="auto"``, whose gathered subsets of fewer than 8 lanes must
   still launch K4.

Launch counters are zeroed just before each main-path run (phases 4, 5, 7, 9, 10, 12, 13, 14, 15 and 16)
and read just after it; a kernel of the path that did not launch fails the
run. The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs no network and one card.
"""

from __future__ import annotations

import functools
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

# Acceptance bounds. Errors are normwise: max|kernel - plain| / max|plain|
# per output tensor, kernel and plain form on the same inputs on the card.
F64_KERNEL_REL = 1e-10
# float32: the kernel and the plain form round in different orders (FMA
# contraction, products summed in other orders) over a 100-step recursion or
# rollout; 1e-4 is about 800 float32 epsilons. PERF.md gives the measured values.
F32_KERNEL_REL = 1e-4
# Phase 4, float32: fused (K1 + K2) against seq + xla after 6 iterations:
# relative cost difference and max |u difference| in newtons (hover thrust is
# about 2.45 N per rotor).
F32_SOLVE_COST_REL = 1e-4
F32_SOLVE_U_ABS = 1e-2
# K3 against its plain form. float64: the same law in another summation
# order. float32: trajectories and gains after up to 10 trips at H=100, held
# to the bound of the other kernels (PERF.md gives the measured values); the
# feedforward gain k vanishes at the optimum, so it is held on the controls'
# scale (max |u|), not its own.
F64_K3_REL = 1e-9
F32_K3_REL = 1e-4
F32_K3_COST_REL = 1e-4
MPC_ERROR_BAR = 0.05
MPC_STEPS = 300  # closed-loop steps per mode, the span of the error bar
# The hybrid controller (the slowest step of all, about a second) runs
# 100 steps and is held to the pure controller's closed loop at the same
# step, whose 300 steps are held to the error bar. With the exact fallback
# both solve each step to the same optimum: in a CPU run of the port
# (float32) the two loops differ by at most 1.1e-4 on the way and by 2.7e-5
# after 100 steps, where ||x - x_ref|| is still 0.226. The bar is 1e-3.
HYBRID_STEPS = 100
HYBRID_TRACK_BAR = 1e-3
SIMULATE_STEPS = 10  # megakernel steps timed with simulate as the initial rollout
# Cart-pole, 300 steps from [0.15, 0, 0.2, 0] against the port's RK4 plant. A
# CPU run of the port ends at ||x|| = 0.0996 with solver="megakernel"
# (max_iter=6) and at 0.0198 in mode "blend", in float32 and in float64 alike;
# the bars are 1.5 times that.
CARTPOLE_MEGAKERNEL_BAR = 0.15
CARTPOLE_BLEND_BAR = 0.03
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)
# The batched path at benchmarks/suite.py's throughput problem: quadrotor RK4,
# H=50, 4 forced iterations, at batch widths on both sides of the JAX
# dispatch's 1024.
BATCHES = (512, 2048)
BATCH_H = 50
BATCH_ITERS = 4
# bfloat16 stage inputs against the exact float32 form: JAX's band
# (tests/test_fused_riccati.py), normwise.
BF16_BAND = 5e-2
# The batched solve, "fused" against "vmap" in float64: JAX's tolerances for
# its two backends (tests/test_fused_riccati.py).
F64_BATCH_COST_RTOL = 1e-9
F64_BATCH_U_ATOL = 1e-8
K5_TILE_S = 8  # K5's packed layout: full 8 x 128 tiles at B=2048, as on the TPU
# MPC steps traced for the device idle share. They go on from the end of the
# closed loop: warm-started steps, as all but the first few of a loop are. (A
# cold first step of the while solver takes many iterations of tens of
# thousands of launches each, and tracing it cost up to a minute.)
IDLE_STEPS = 3
# K8 alone: benchmarks/suite.py's shapes (m=4, r=13) and the widest launch of
# the main path (the batched associative solve at B=2048, H=50: 102,400
# systems, r = 1 + 2n for the stage elements and 1 + n for the gains).
K8_SHAPES = ((301, 13, torch.float32), (65536, 13, torch.float32), (1048576, 13, torch.float32),
             (65536, 13, torch.float64), (102400, 25, torch.float32), (102400, 13, torch.float32))
K8_MAIN = (102400, 25, torch.float32)  # the shape of the kernels line
# K9 alone: the suite's shapes (n=12) and the main path's (the KKT route, float64, N = H = 1024).
K9_SHAPES = ((1024, torch.float32), (131072, torch.float32), (1024, torch.float64), (131072, torch.float64))
K9_MAIN = (1024, torch.float64)
# K1 timed at the bench stages' H=50 and 100 and at the suite's random LQ problem's H=1,024.
K1_TIMED = (50, 100, 1024)
# K2 timed at the bench stages' H=50 and 100 and at H=1,024 (hover_stages: no eager loop over the horizon).
K2_TIMED = (50, 100, 1024)
# The associative Riccati form against K1: JAX's tolerance for the two forms,
# which place reg differently (tests/test_riccati.py:110-113).
ASSOC_K1_RTOL, ASSOC_K1_ATOL = 1e-3, 1e-6
ASSOC_MPC_STEPS = 20
# The KKT route: residual relative to the rhs scale, and dx against the
# Riccati Newton step (tests/test_ops.py:130-154).
KKT_RESIDUAL_REL = 1e-8
KKT_DX_RTOL, KKT_DX_ATOL = 1e-5, 1e-8
# The training path (phase 13): quadrotor RK4 at dt=0.01, H=50, the example
# collection's cost (examples/collect_and_train.py), ILQRConfig(tol=1e-3,
# max_iter=8, linesearch="fused"), 1,024 initial states from the "reference"
# LHS envelope (x, y, z, roll, pitch, yaw), 10 MPC steps, compact_iters=3.
TRAIN_H = 50
TRAIN_BATCH = 1024
TRAIN_SIM_STEPS = 10
TRAIN_MAX_ITER = 8
TRAIN_COMPACT = 3
TRAIN_ENVELOPE = ((-0.3, -0.3, 0.49, -0.2, -0.2, -0.5), (0.3, 0.3, 0.51, 0.2, 0.2, 0.5))
# float64, the fused backend against "vmap": test_torch_batch.py's bars for u and gains, normwise.
PARITY_BATCH = 64
PARITY_STEPS = 3
PARITY_X_REL = 1e-8
PARITY_KK_REL = 1e-7
# The shipped quadrotor predictor's width (checkpoints/quadrotor_gain.npz): trained 2 epochs, batch 256.
SHIPPED_PARAMS = 616244
TRAIN_ROWS_PER_STEP = 256
TRAIN_EPOCHS = 2
# Adam steps on the card against the CPU (float32, TF32 off): per-step loss, relative.
CPU_STEPS = 5
TRAIN_CPU_REL = 1e-4
TRAINED_HYBRID_STEPS = 10

# The card's peaks (float32 and float64 without tensor cores, HBM3) come from
# quattro_tpu_torch/utils/roofline.py's "h100-sxm" entry (see bound_ms).
# Phase 14, the mesh path. Virtual meshes: every shard on the one card.
MESH_SHARDS = 8
MESH_F64_BATCH, MESH_F64_SHARDS = 512, 4
MESH_H = 1024
POD_BATCH, POD_H = 4096, 1024  # BASELINE.json config 5
POD_F64_BATCH, POD_F64_H = 64, 256
MESH_TRAIN_SHARDS, MESH_TRAIN_STEPS, MESH_TRAIN_ROWS = 4, 5, 256
# tests/test_parallel.py's tolerances: the sharded solve against the unsharded one (float64), the horizon
# pass against the sequential one (K1 here), the pod-scale pass against per-trajectory passes (K4 here).
MESH_F64_COST_RTOL, MESH_F64_U_ATOL = 1e-8, 1e-8
HORIZON_VX_TOL, HORIZON_GAIN_TOL = (1e-4, 1e-5), (1e-3, 1e-5)
POD_GAIN_TOL, POD_VX_TOL = (2e-3, 1e-5), (1e-3, 1e-5)
MESH_CPU_REL = 1e-9  # a sharded pass on the card against the same pass on a CPU mesh, float64, normwise
TREE_RING_REL = 1e-12
MESH_TRAIN_REL = 1e-5

# Phase 15, the examples: the three runs of examples/collect_and_train_cuda.py (its defaults otherwise, among
# them --num-inits 64, --max-iter 8 and the model width), cut in depth only (--sim-steps, --epochs).
EXAMPLE_RUNS = (
    ("quadrotor_model", ["--system", "quadrotor", "--plant", "model", "--quad-params", "nominal",
                         "--device-resident", "--sim-steps", "10", "--epochs", "2", "--out", "quad.npz"]),
    ("quadrotor_randomized", ["--system", "quadrotor", "--plant", "randomized", "--quad-params", "nominal",
                              "--sim-steps", "5", "--epochs", "0", "--out", "unused.npz"]),
    ("cartpole_model", ["--system", "cartpole", "--plant", "model", "--sim-steps", "10", "--epochs", "1",
                        "--out", "cp.npz"]),
)
EXAMPLE_HYBRID_STEPS = 20

# Phase 16, the batched hybrid solve: benchmarks/suite.py's bench_hybrid_speedup_batched problem, B=64, 4
# forced iterations, with the shipped long-horizon checkpoints as they are (window 16; state strides 4 and 8).
HYBRID_BATCH = 64
HYBRID_ITERS = 4
HYBRID_RUNS = ((256, "quadrotor_h256_gain.npz"), (512, "quadrotor_h512_gain.npz"))
HYBRID_TIMED_CALLS = 3
HOVER_THRUST = 2.4525
# Lanes against their single solves on the card: float32 (phase 16's B=64 at H=256) on the cost; float64 on
# 8 lanes, half of them near the hover, where the hybrid step ends them or the exact fallback takes over within
# 3 iterations at tol 0.1 (a CPU run of the port: fallbacks over 4 and 4 lanes at H=256, 3 and 3 at H=50).
F32_HYBRID_COST_RTOL = 1e-4
F32_SINGLE_WORKERS = 4  # processes for the 64 float32 single solves (the card's machine has 8 cores)
HYBRID_PARITY_BATCH, HYBRID_PARITY_NEAR, HYBRID_PARITY_ITERS, HYBRID_PARITY_TOL = 8, 4, 3, 0.1
HYBRID_PARITY_RUNS = ((256, "quadrotor_h256_gain.npz"), (50, "quadrotor_gain.npz"))

# queued_ms's sleep kernel: about 3 ms of the card's clock, longer than the host takes to queue 50 calls.
QUEUE_SLEEP_CYCLES = 5_000_000
QUEUED = {True: "", False: " (not queued ahead: host gaps count)"}

K1 = "fused_riccati_single"
K2 = "fused_rollout_single"
K3 = "fused_solve"
K4 = "fused_riccati_batched"
K5 = "fused_linquad"
K6 = "fused_rollout_batched2d"  # launch count of fused_feedback_rollouts_batched2d
K7 = "fused_rollout_batched"  # launch count of fused_feedback_rollouts_batched, and the source K6 shares
K8 = "batched_cholesky"
K9 = "btd_matvec"
SOURCES = (K1, K2, K3, K4, K5, K7, K8, K9)
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def time_ms(fn, reps, warm=True):
    """Per-call device time with CUDA events, after one warm-up call unless the caller has made it."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Device time per call of ``fn``: CUDA events around ``reps`` calls queued behind a sleep kernel, so the
    device runs them back to back (each call's kernels and the device's gap between launches) and the host's
    time per call does not count. Returns (ms, queued): ``queued`` is False where the host took longer to
    queue the calls than the sleep lasted, as for a call that synchronizes (``torch.linalg.solve`` checks its
    result on the host); the time then includes the host's gaps between calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    host = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - host)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms < _sleep_ms()


@functools.lru_cache(maxsize=None)
def _sleep_ms():
    """How long the sleep kernel of ``queued_ms`` lasts on this card (ms)."""
    return time_ms(lambda: torch.cuda._sleep(QUEUE_SLEEP_CYCLES), 3)


def in_turns(kernel, library, reps, rounds=5):
    """Per-call ms of a kernel's public call and of the library call: CUDA events around ``reps`` calls,
    in turns kernel, library, kernel, library, ... (``rounds`` turns each); the least of each.

    Where the host takes longer per call than the device, this is the host's rate, which a shared host
    disturbs now and then; the least of several turns is the undisturbed rate of each.
    """
    kernel_ms, library_ms = [], []
    for _ in range(rounds):
        kernel_ms.append(time_ms(kernel, reps))
        library_ms.append(time_ms(library, reps))
    return min(kernel_ms), min(library_ms)


def bench_problem(dtype, horizon=100, device="cuda"):
    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    dev = torch.device(device)
    x_ref = torch.zeros(12, dtype=dtype, device=dev)
    x_ref[2] = 0.5
    q = torch.tensor(Q, dtype=dtype, device=dev)
    dyn = make_discrete(QuadrotorField(), 0.01, "rk4")
    cost = make_quadratic_cost(q, torch.full((4,), 0.01, dtype=dtype, device=dev), x_ref, barrier_alpha=1000.0)
    fcost = make_quadratic_final_cost(torch.tensor(QF, dtype=dtype, device=dev), x_ref)
    x0 = torch.zeros(12, dtype=dtype, device=dev)
    x0[2], x0[6] = 0.2, 0.1
    u0 = torch.zeros(horizon, 4, dtype=dtype, device=dev)
    return dyn, cost, fcost, x0, u0


def cartpole_problem(dtype, horizon=30):
    """The cart-pole MPC's problem (make_cartpole_mpc's tables) from [0.15, 0, 0.2, 0] and zero controls."""
    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import CartPoleField, make_discrete

    t = lambda v: torch.tensor(v, dtype=dtype, device="cuda")
    x_ref = t([0.0] * 4)
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    cost = make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), x_ref)
    fcost = make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), x_ref)
    return dyn, cost, fcost, t([0.15, 0.0, 0.2, 0.0]), torch.zeros(horizon, 1, dtype=dtype, device="cuda")


@functools.lru_cache(maxsize=None)
def bench_stages(dtype, horizon=100):
    """Stage data of the bench problem's first backward pass, and gains from it."""
    from quattro_tpu_torch.solver import (
        linearize_dynamics, quadratize_cost, quadratize_final_cost, riccati_backward, simulate,
    )

    dyn, cost, fcost, x0, u0 = bench_problem(dtype, horizon)
    x_seq = simulate(dyn, x0, u0)
    a, b = linearize_dynamics(dyn, x_seq, u0)
    exp = quadratize_cost(cost, x_seq, u0)
    fin = quadratize_final_cost(fcost, x_seq[-1])
    gains = riccati_backward(a, b, exp, fin.v_x, fin.v_xx, 1e-6)
    return dyn, (a, b, exp, fin.v_x, fin.v_xx), x0, x_seq, u0, gains


def k1_work(horizon, n, m, dtype):
    """(bytes, flops) K1 must move and do: inputs read once, outputs written once."""
    size = torch.finfo(dtype).bits // 8
    inputs = horizon * (2 * n * n + n * m + n + m + m * m + m * n) + n + n * n
    outputs = horizon * (m + m * n) + (horizon + 1) * (n + n * n)
    step = (
        4 * n**3 + 8 * n * n * m + 2 * n * n + 2 * n * m + 2 * n * m * m  # Q-expansion
        + m**3 // 3 + 2 * m * m * (n + 1)  # Cholesky + two substitutions
        + 2 * m * m + 4 * n * n * m + 4 * n * m  # value update
    )
    return (inputs + outputs) * size, horizon * step


def k2_work(horizon, n_alpha, dtype):
    size = torch.finfo(dtype).bits // 8
    n, m = 12, 4
    inputs = n + horizon * (n + m + m + m * n) + n_alpha
    outputs = n_alpha * ((horizon + 1) * n + horizon * m)
    field = 80  # flops of one vector-field evaluation, sin/cos/tan/divide counted as one each
    step = m * (2 * n + 2) + n + 4 * field + 6 * n + 5 * n
    return (inputs + outputs) * size, n_alpha * horizon * step


def bound_ms(work, dtype):
    from quattro_tpu_torch.utils.roofline import PEAKS

    peak = PEAKS["h100-sxm"]
    nbytes, flops = work
    t_bytes, t_ops = nbytes / peak.hbm_bytes, flops / peak.flops(dtype)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k1(report):
    from quattro_tpu_torch.ops.fused_riccati import (
        riccati_backward_fused_single, riccati_backward_fused_single_plain,
    )

    for dtype in (torch.float64, torch.float32):
        _, stages, *_ = bench_stages(dtype)
        out = riccati_backward_fused_single(*stages, 1e-6)
        ref = riccati_backward_fused_single_plain(*stages, 1e-6)
        torch.cuda.synchronize()
        errs = {name: rel_err(o, r) for name, o, r in zip(("k", "K", "V_x", "V_xx"), out, ref)}
        # K1 does not symmetrize V_xx (nor does its TPU original): its drift
        # from symmetry over the horizon is held to the same bound.
        sym = float((out[3] - out[3].transpose(-1, -2)).abs().max() / out[3].abs().max())
        bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
        log(f"K1 {dtype}: rel err {errs} (bound {bound}); V_xx asymmetry {sym:.3e}")
        if not all(np.isfinite(v) and v <= bound for v in [*errs.values(), sym]):
            raise AssertionError(f"K1 disagrees with its plain form in {dtype}: {errs}, asymmetry {sym}")
        if dtype == torch.float32:
            ms = time_ms(lambda: riccati_backward_fused_single(*stages, 1e-6), 200)
            plain_ms = time_ms(lambda: riccati_backward_fused_single_plain(*stages, 1e-6), 5)
            b_ms, b_by = bound_ms(k1_work(100, 12, 4, dtype), dtype)
            report[K1] = dict(
                name=K1, route="cuda", source="quattro_tpu_torch/csrc/fused_riccati_single.cu",
                replaces="quattro_tpu/ops/fused_riccati.py:864", launches=0,
                max_abs_err=max(float((o - r).abs().max()) for o, r in zip(out, ref)),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            )
            log(f"K1 float32 H=100: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.2e} ms ({b_by})")
    return k1_timing(torch.float32)


def k1_timing(dtype):
    """K1 at the bench stages' H=50 and 100 and the suite's random LQ H=1,024: the public call's time and the
    device time queued behind a sleep kernel (so the host's time per call does not count), per step beside the
    byte bound per step. The recursion is a chain of H steps, so the time per step is what a redesign moves."""
    from quattro_tpu_torch.ops.fused_riccati import riccati_backward_fused_single

    timing = {}
    for horizon in K1_TIMED:
        stages = random_lq(horizon, dtype) if horizon == 1024 else bench_stages(dtype, horizon)[1]
        call = lambda: riccati_backward_fused_single(*stages, 1e-6)
        call_ms = time_ms(call, 100)
        dev_ms, queued = queued_ms(call, 10)  # ten calls queue within the sleep (about 0.13 ms of host time each)
        b_ms, b_by = bound_ms(k1_work(horizon, 12, 4, dtype), dtype)
        timing[horizon] = dict(call_ms=call_ms, queued_ms=dev_ms, queued=queued, us_per_step=1e3 * dev_ms / horizon,
                               bound_us_per_step=1e3 * b_ms / horizon)
        log(f"K1 float32 H={horizon}: call {call_ms:.4f} ms, device {dev_ms:.4f} ms{QUEUED[queued]}, "
            f"{1e3 * dev_ms / horizon:.3f} us per step (bound {1e3 * b_ms / horizon:.2e} us per step, {b_by})")
    return timing


def phase_k2(report):
    from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts, fused_feedback_rollouts_plain
    from quattro_tpu_torch.solver import (
        linearize_dynamics, quadratize_cost, quadratize_final_cost, riccati_backward, simulate,
    )
    from quattro_tpu_torch.solver.ilqr import _initial_rollout

    for dtype in (torch.float64, torch.float32):
        dyn, _, x0, x_seq, u0, gains = bench_stages(dtype)
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.05, 0.01], dtype=dtype, device=x0.device)
        args = (dyn, x0, x_seq, u0, gains.k_seq, gains.big_k_seq, alphas)
        out = fused_feedback_rollouts(*args)
        ref = fused_feedback_rollouts_plain(*args)
        torch.cuda.synchronize()
        errs = {name: rel_err(o, r) for name, o, r in zip(("cand_x", "cand_u"), out, ref)}
        bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
        log(f"K2 {dtype}: rel err {errs} (bound {bound})")
        if not all(np.isfinite(v) and v <= bound for v in errs.values()):
            raise AssertionError(f"K2 disagrees with its plain form in {dtype}: {errs}")
        if dtype == torch.float32:
            ms = time_ms(lambda: fused_feedback_rollouts(*args), 200)
            plain_ms = time_ms(lambda: fused_feedback_rollouts_plain(*args), 5)
            b_ms, b_by = bound_ms(k2_work(100, 6, dtype), dtype)
            report[K2] = dict(
                name=K2, route="cuda", source="quattro_tpu_torch/csrc/fused_rollout_single.cu",
                replaces="quattro_tpu/ops/fused_rollout.py:48", launches=0,
                max_abs_err=max(float((o - r).abs().max()) for o, r in zip(out, ref)),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            )
            log(f"K2 float32 H=100 A=6: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.2e} ms ({b_by})")

        # The cart-pole's device code: gains of its first backward pass at H=30.
        dyn, cost, fcost, x0, u0 = cartpole_problem(dtype)
        x_seq = simulate(dyn, x0, u0)
        a, b = linearize_dynamics(dyn, x_seq, u0)
        fin = quadratize_final_cost(fcost, x_seq[-1])
        gains = riccati_backward(a, b, quadratize_cost(cost, x_seq, u0), fin.v_x, fin.v_xx, 1e-6)
        args = (dyn, x0, x_seq, u0, gains.k_seq, gains.big_k_seq, torch.tensor(ALPHAS, dtype=dtype, device=x0.device))
        out = fused_feedback_rollouts(*args)
        ref = fused_feedback_rollouts_plain(*args)
        torch.cuda.synchronize()
        errs = {name: rel_err(o, r) for name, o, r in zip(("cand_x", "cand_u"), out, ref)}
        log(f"K2 cart-pole {dtype}: rel err {errs} (bound {bound})")
        if not all(np.isfinite(v) and v <= bound for v in errs.values()):
            raise AssertionError(f"K2 disagrees with its plain form on the cart-pole in {dtype}: {errs}")

        # The shape the megakernel path launches K2 at: the solve's initial
        # rollout (one candidate, zero gains) of a warm start, against simulate.
        gen = torch.Generator().manual_seed(0)
        for label, problem, hover in (("quadrotor H=50", lambda dt: bench_problem(dt, 50), 2.4525),
                                      ("cart-pole H=30", cartpole_problem, 0.0)):
            dyn, _, _, x0, u0 = problem(dtype)
            u_warm = u0 + hover + 0.1 * torch.randn(u0.shape, generator=gen, dtype=dtype).to(u0.device)
            err = rel_err(_initial_rollout(dyn, x0, u_warm), simulate(dyn, x0, u_warm))
            log(f"K2 as the initial rollout, {label} {dtype}: rel err {err:.3e} against simulate (bound {bound})")
            if not (np.isfinite(err) and err <= bound):
                raise AssertionError(f"K2's initial rollout disagrees with simulate ({label}, {dtype}): {err}")
    return k2_timing(torch.float32)


def hover_stages(dtype, horizon):
    """K2's inputs at any horizon without an eager loop over it: the bench problem from hover controls, its
    open-loop trajectory by one K2 launch (the megakernel path's initial rollout) and its first backward pass
    by one K1 launch, both in float64 and then cast (in float32 that pass overflows over 1,024 steps)."""
    from quattro_tpu_torch.solver import (
        RiccatiResult, linearize_dynamics, quadratize_cost, quadratize_final_cost, riccati_backward_fused,
    )
    from quattro_tpu_torch.solver.ilqr import _initial_rollout

    dyn, cost, fcost, x0, u0 = bench_problem(torch.float64, horizon)
    u = u0 + 2.4525
    x_seq = _initial_rollout(dyn, x0, u)
    a, b = linearize_dynamics(dyn, x_seq, u)
    fin = quadratize_final_cost(fcost, x_seq[-1])
    gains = riccati_backward_fused(a, b, quadratize_cost(cost, x_seq, u), fin.v_x, fin.v_xx, 1e-6)
    cast = lambda t: t.to(dtype)
    return dyn, cast(x0), cast(x_seq), cast(u), RiccatiResult(*(cast(t) for t in gains))


def k2_timing(dtype):
    """K2 (A=6) at the bench stages' H=50 and 100 and at H=1,024 (hover_stages): the public call's time and the
    device time queued behind a sleep kernel, per step beside the bound per step. Each candidate is a chain of H
    steps, so the time per step is what a redesign moves. The time depends on the data: on hover_stages' inputs
    at H=100 it was 1.44 times the bench stages' (an H100), so each horizon keeps its inputs."""
    from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts

    timing = {}
    for horizon in K2_TIMED:
        if horizon == 1024:
            dyn, x0, x_seq, u0, gains = hover_stages(dtype, horizon)
        else:
            dyn, _, x0, x_seq, u0, gains = bench_stages(dtype, horizon)
        alphas = torch.tensor(ALPHAS, dtype=dtype, device=x0.device)
        call = lambda: fused_feedback_rollouts(dyn, x0, x_seq, u0, gains.k_seq, gains.big_k_seq, alphas)
        if not all(bool(torch.isfinite(o).all()) for o in call()):
            raise AssertionError(f"K2 at H={horizon}: non-finite candidates")
        call_ms = time_ms(call, 100)
        dev_ms, queued = queued_ms(call, 10)
        b_ms, b_by = bound_ms(k2_work(horizon, len(ALPHAS), dtype), dtype)
        timing[horizon] = dict(call_ms=call_ms, queued_ms=dev_ms, queued=queued, us_per_step=1e3 * dev_ms / horizon,
                               bound_us_per_step=1e3 * b_ms / horizon)
        log(f"K2 float32 H={horizon} A=6: call {call_ms:.4f} ms, device {dev_ms:.4f} ms{QUEUED[queued]}, "
            f"{1e3 * dev_ms / horizon:.3f} us per step (bound {1e3 * b_ms / horizon:.2e} us per step, {b_by})")
    return timing


def k3_work(horizon, n, m, n_alpha, trips, field_flops, dtype):
    """(bytes, flops) of one K3 solve: every one of the fixed trips does its full work."""
    size = torch.finfo(dtype).bits // 8
    inputs = (horizon + 1) * n + horizon * m + 1 + 2 * n * n + m * m + 2 * n + n_alpha
    outputs = (horizon + 1) * n + 2 * horizon * m + horizon * m * n + 3
    # What jacfwd of the RK4 step needs: the four field values and their
    # combination once per time step, and per Jacobian column the tangent
    # alone through every operation (twice a field's flops) and the combination.
    linearize = horizon * ((4 * field_flops + 6 * n) + (n + m) * (4 * 2 * field_flops + 12 * n))
    quadratize = horizon * (2 * n * n + 2 * m * m + 30 * m)
    riccati = k1_work(horizon, n, m, dtype)[1]
    step_cost = 2 * n * n + 2 * n + 2 * m * m + 2 * m + 12 * m
    rollouts = n_alpha * horizon * (m * (2 * n + 2) + n + 4 * field_flops + 11 * n + step_cost)
    return (inputs + outputs) * size, trips * (linearize + quadratize + riccati + rollouts)


def phase_k3(report):
    """K3 against its plain form at the shapes the entry points give it."""
    from quattro_tpu_torch.ops.fused_solve import _prepare, fused_ilqr_solve_kernel, fused_ilqr_solve_kernel_plain
    from quattro_tpu_torch.solver import simulate, trajectory_cost

    k3_timing = {}

    # (label, problem, n, m, flops per field evaluation, converging (tol, trips), forced trips by dtype).
    # Forced trips stop while the solve still descends in that precision:
    # past that, accepts are ties that either summation order may win.
    shapes = [
        ("quadrotor H=50", lambda dt: bench_problem(dt, 50), 12, 4, 80, (0.2, 10), {torch.float64: 6, torch.float32: 6}),
        ("quadrotor H=100", lambda dt: bench_problem(dt, 100), 12, 4, 80, (0.2, 10), {torch.float64: 6, torch.float32: 6}),
        ("cart-pole H=30", cartpole_problem, 4, 1, 30, (1e-1, 6), {torch.float64: 3, torch.float32: 2}),
    ]
    for label, problem, n, m, field_flops, converging, forced in shapes:
        for dtype in (torch.float64, torch.float32):
            dyn, cost, fcost, x0, u0 = problem(dtype)
            horizon = u0.shape[0]
            x_init = simulate(dyn, x0, u0)
            cost_init = trajectory_cost(cost, fcost, x_init, u0)
            for kind, (tol, trips) in (("forced", (0.0, forced[dtype])), ("converging", converging)):
                args = (dyn, cost, fcost, x_init, u0, cost_init, trips, tol, 1e-6, ALPHAS)
                out = fused_ilqr_solve_kernel(*args)
                torch.cuda.synchronize()
                start = time.perf_counter()
                ref = fused_ilqr_solve_kernel_plain(*args)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - start)
                x, u, k, big_k, stats = out
                rx, ru, rk, rbig_k, rstats = ref
                u_scale = max(float(ru.abs().max()), float(rk.abs().max()), 1e-30)
                errs = dict(x=rel_err(x, rx), u=rel_err(u, ru), K=rel_err(big_k, rbig_k),
                            k=float((k - rk).abs().max()) / u_scale)
                cost_rel = abs(float(stats[0, 0]) - float(rstats[0, 0])) / abs(float(rstats[0, 0]))
                bound, cost_bound = (F64_K3_REL, F64_K3_REL) if dtype == torch.float64 else (F32_K3_REL, F32_K3_COST_REL)
                flags, rflags = stats[0, 1:].tolist(), rstats[0, 1:].tolist()
                log(f"K3 {label} {dtype} {kind} (tol {tol}, {trips} trips): iters/converged {flags} plain {rflags}; "
                    f"rel err {errs} (bound {bound}), cost rel {cost_rel:.3e} (bound {cost_bound}); plain {plain_ms:.1f} ms")
                if flags != rflags:
                    raise AssertionError(f"K3 {label} {dtype} {kind}: iters/converged {flags}, plain form {rflags}")
                if kind == "forced" and flags != [float(trips), 0.0]:
                    raise AssertionError(f"K3 {label} {dtype}: the forced run did not take its {trips} trips: {flags}")
                if kind == "converging" and not (flags[1] == 1.0 and flags[0] < trips):
                    raise AssertionError(f"K3 {label} {dtype}: the converging run did not converge early: {flags}")
                if not all(np.isfinite(v) and v <= bound for v in errs.values()) or not cost_rel <= cost_bound:
                    raise AssertionError(f"K3 disagrees with its plain form ({label}, {dtype}, {kind}): {errs}, cost {cost_rel}")
                if kind == "forced":
                    ms = time_ms(lambda: fused_ilqr_solve_kernel(*args), 50)
                    b_ms, b_by = bound_ms(k3_work(horizon, n, m, len(ALPHAS), trips, field_flops, dtype), dtype)
                    # The public call copies the step sizes to the card (a stream sync), so the device time is
                    # taken on the bare C entry point with prepared pointers, queued behind a sleep kernel.
                    fn, bare_args, _, _tensors = _prepare(*args)  # _tensors keeps the pointed-to tensors alive
                    stream = torch.cuda.current_stream().cuda_stream
                    dev_ms, queued = queued_ms(lambda: fn(*bare_args, stream), 20)
                    per_step = 1e3 * dev_ms / (trips * horizon)
                    log(f"K3 {label} {dtype}, {trips} trips: call {ms:.4f} ms, device {dev_ms:.4f} ms{QUEUED[queued]} "
                        f"({per_step:.3f} us per time step per trip), plain {plain_ms:.1f} ms, bound {b_ms:.2e} ms ({b_by})")
                    if dtype == torch.float32 and label.startswith("quadrotor"):
                        k3_timing[horizon] = dict(call_ms=ms, queued_ms=dev_ms, queued=queued, us_per_step_per_trip=per_step)
                    if dtype == torch.float32 and label == "quadrotor H=50":  # the shape the MPC path launches it at
                        report[K3] = dict(
                            name=K3, route="cuda", source="quattro_tpu_torch/csrc/fused_solve.cu",
                            replaces="quattro_tpu/ops/fused_solve.py:70", launches=0,
                            max_abs_err=max(float((o - r).abs().max()) for o, r in zip(out, ref)),
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        )
    return k3_timing


def suite_batch(dtype, batch, seed=0):
    """benchmarks/suite.py's throughput problem: (dyn, cost, fcost, x0 (B, 12), u0 (B, H, 4)).

    The bench problem's tables (Q, R = 0.01, barrier_alpha = 1000, Qf, x_ref
    z = 0.5), x0 z drawn uniformly in [0.2, 0.5] from a numpy seed, zero controls.
    """
    dyn, cost, fcost, _, _ = bench_problem(dtype, BATCH_H)
    x0 = torch.zeros(batch, 12, dtype=dtype, device="cuda")
    x0[:, 2] = torch.from_numpy(0.2 + 0.3 * np.random.default_rng(seed).random(batch)).to(x0)
    return dyn, cost, fcost, x0, torch.zeros(batch, BATCH_H, 4, dtype=dtype, device="cuda")


@functools.lru_cache(maxsize=None)
def warm_batch(dtype, batch):
    """A warm-started batch of the suite's problem and its first backward pass's stage data.

    x0 also gets small seeded velocities and attitudes and the controls hover
    plus noise, so that every trajectory's stages differ (at zero controls and
    level attitude all A_t are equal, which would hide a lane read from the
    wrong trajectory). Returns (dyn, cost, xs, us, stages, v_x_final, v_xx_final).
    """
    from torch.func import vmap

    from quattro_tpu_torch.solver import linearize_dynamics, quadratize_cost, quadratize_final_cost, simulate

    dyn, cost, fcost, x0, u0 = suite_batch(dtype, batch)
    rng = np.random.default_rng(1)
    x0[:, 3:12] = torch.from_numpy(0.1 * rng.standard_normal((batch, 9))).to(x0)
    us = u0 + 2.4525 + torch.from_numpy(0.1 * rng.standard_normal(tuple(u0.shape))).to(u0)
    xs = vmap(functools.partial(simulate, dyn))(x0, us)
    a, b = vmap(functools.partial(linearize_dynamics, dyn))(xs, us)
    exp = vmap(functools.partial(quadratize_cost, cost))(xs, us)
    fin = vmap(functools.partial(quadratize_final_cost, fcost))(xs[:, -1])
    return dyn, cost, xs, us, (a, b, exp), fin.v_x, fin.v_xx


def stage_entries(n, m):
    return 2 * n * n + 2 * n * m + m * m + n + m


def k4_work(batch, horizon, n, m, dtype):
    """(bytes, flops) of the batched backward pass: K1's step on every trajectory; gains only."""
    size = torch.finfo(dtype).bits // 8
    inputs = batch * (horizon * stage_entries(n, m) + n + n * n)
    outputs = batch * horizon * (m + m * n)
    return (inputs + outputs) * size, batch * k1_work(horizon, n, m, dtype)[1]


def k5_work(batch, horizon, n, m, field_flops, dtype):
    """(bytes, flops) of linearize + quadratize at every (b, t): the stage data written once."""
    size = torch.finfo(dtype).bits // 8
    inputs = batch * ((horizon + 1) * n + horizon * m) + n * n + m * m + n
    outputs = batch * horizon * stage_entries(n, m)
    linearize = (4 * field_flops + 6 * n) + (n + m) * (4 * 2 * field_flops + 12 * n)  # as in k3_work
    quadratize = 2 * n * n + 2 * m * m + 30 * m
    return (inputs + outputs) * size, batch * horizon * (linearize + quadratize)


def k6_work(batch, horizon, n_alpha, dtype):
    """(bytes, flops) of the all-alpha rollouts of a batch: K2's work on every trajectory."""
    size = torch.finfo(dtype).bits // 8
    n_bytes, flops = k2_work(horizon, n_alpha, dtype)
    n, m = 12, 4
    inputs = batch * (n + (horizon + 1) * n + horizon * (2 * m + m * n)) + n_alpha
    outputs = n_alpha * batch * ((horizon + 1) * n + horizon * m)
    return (inputs + outputs) * size, batch * flops


def rel_errs(names, outs, refs):
    return {name: rel_err(o, r) for name, o, r in zip(names, outs, refs)}


def check(label, errs, bound):
    log(f"{label}: rel err {errs} (bound {bound})")
    if not all(np.isfinite(v) and v <= bound for v in errs.values()):
        raise AssertionError(f"{label} disagrees with its plain form: {errs}")


def phase_k4(report):
    """K4 on its three entry points against its plain form, lane-wise against K1, and with a bfloat16 stream."""
    from quattro_tpu_torch.ops import fused_riccati as fr
    from quattro_tpu_torch.solver import CostExpansion

    for batch in BATCHES:
        for dtype in (torch.float64, torch.float32):
            _, _, _, _, (a, b, exp), v_x, v_xx = warm_batch(dtype, batch)
            args = (a, b, exp, v_x, v_xx, 1e-6)
            ref = fr.riccati_backward_batched_fused_plain(*args)
            tile_s = fr.default_tile_s(batch)
            packed = fr.pack_stages((a, b, exp.l_xx, exp.l_uu, exp.l_ux, exp.l_x, exp.l_u), tile_s, BATCH_H)
            runs = {
                "column": lambda: fr.riccati_backward_batched_fused(*args),
                "batch2d": lambda: fr.riccati_backward_batched_fused2d(*args),
                "auto": lambda: fr.riccati_backward_batched_fused_auto(*args),
                "packed": lambda: fr.riccati_backward_batched_fused2d(
                    None, None, None, v_x, v_xx, 1e-6, tile_s=tile_s, packed_stage=packed, horizon=BATCH_H),
            }
            bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
            outs = {}
            for entry, run in runs.items():
                outs[entry] = run()
                torch.cuda.synchronize()
                check(f"K4 {entry} B={batch} {dtype}", rel_errs(("k", "K"), outs[entry], ref), bound)
            # K4 runs K1's step unchanged, so a lane is one K1 launch on that trajectory, bit for bit.
            for lane in (0, batch // 2, batch - 1):
                k1 = fr.riccati_backward_fused_single(a[lane], b[lane], CostExpansion(*(e[lane] for e in exp)),
                                                      v_x[lane], v_xx[lane], 1e-6)
                if not (torch.equal(k1[0], outs["column"][0][lane]) and torch.equal(k1[1], outs["column"][1][lane])):
                    raise AssertionError(f"K4 lane {lane} (B={batch}, {dtype}) differs from K1 on that trajectory")
            log(f"K4 B={batch} {dtype}: lanes 0, {batch // 2}, {batch - 1} equal K1 bit for bit")
            if dtype != torch.float32:
                continue
            out16 = fr.riccati_backward_batched_fused(*args, stream_dtype=torch.bfloat16)
            ref16 = fr.riccati_backward_batched_fused_plain(*args, stream_dtype=torch.bfloat16)
            check(f"K4 bf16 stream B={batch}", rel_errs(("k", "K"), out16, ref16), F32_KERNEL_REL)
            band = rel_errs(("k", "K"), out16, ref)
            log(f"K4 bf16 stream B={batch} against the exact float32 form: {band} (band {BF16_BAND})")
            if not all(0.0 < v < BF16_BAND for v in band.values()):
                raise AssertionError(f"K4 bf16 stream outside JAX's band of float32: {band}")
            ms = time_ms(runs["column"], 50)
            ms_packed = time_ms(runs["packed"], 50)
            ms16 = time_ms(lambda: fr.riccati_backward_batched_fused(*args, stream_dtype=torch.bfloat16), 50)
            # The kernel alone: the natural call copies the strided stage tensors of vmap's Jacobians first.
            dense = [x.contiguous() for x in (a, b)] + [CostExpansion(*(e.contiguous() for e in exp))]
            dev_ms, queued = queued_ms(lambda: fr.riccati_backward_batched_fused(*dense, v_x, v_xx, 1e-6), 20)
            plain_ms = time_ms(lambda: fr.riccati_backward_batched_fused_plain(*args), 1)
            b_ms, b_by = bound_ms(k4_work(batch, BATCH_H, 12, 4, dtype), dtype)
            log(f"K4 float32 B={batch} H={BATCH_H}: kernel {ms:.4f} ms (packed input {ms_packed:.4f}, bf16 stream "
                f"{ms16:.4f}; contiguous natural input, device {dev_ms:.4f}{QUEUED[queued]}), plain {plain_ms:.1f} ms, "
                f"bound {b_ms:.2e} ms ({b_by})")
            if batch == BATCHES[-1]:
                report[K4] = dict(
                    name=K4, route="cuda", source="quattro_tpu_torch/csrc/fused_riccati_batched.cu",
                    replaces="quattro_tpu/ops/fused_riccati.py:59", launches=0,
                    max_abs_err=max(float((o - r).abs().max()) for o, r in zip(outs["column"], ref)),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    packed_ms=ms_packed, bf16_ms=ms16, contiguous_device_ms=dev_ms,
                )


def phase_k5(report):
    """K5 against its plain form on the packed tensors, and K5 -> K4 against K4 on the unpacked stages."""
    from quattro_tpu_torch.ops import fused_riccati as fr
    from quattro_tpu_torch.ops.fused_linquad import linquad_batched_fused, linquad_batched_fused_plain

    batch = BATCHES[-1]
    for dtype in (torch.float64, torch.float32):
        dyn, cost, xs, us, _, v_x, v_xx = warm_batch(dtype, batch)
        out = linquad_batched_fused(dyn, cost, xs, us, tile_s=K5_TILE_S)
        ref = linquad_batched_fused_plain(dyn, cost, xs, us, tile_s=K5_TILE_S)
        torch.cuda.synchronize()
        bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
        check(f"K5 B={batch} tile_s={K5_TILE_S} {dtype}", rel_errs(fr.STAGE_NAMES, out, ref), bound)
        chain = fr.riccati_backward_batched_fused2d(None, None, None, v_x, v_xx, 1e-6, tile_s=K5_TILE_S,
                                                    packed_stage=out, horizon=BATCH_H)
        a, b, l_xx, l_uu, l_ux, l_x, l_u = (fr.unpack_stage(x, batch, BATCH_H, tail, K5_TILE_S)
                                            for x, tail in zip(out, fr.stage_shapes(12, 4)))
        direct = fr.riccati_backward_batched_fused(a, b, (l_x, l_u, l_xx, l_uu, l_ux), v_x, v_xx, 1e-6)
        if not all(torch.equal(c, d) for c, d in zip(chain, direct)):
            raise AssertionError(f"K5 -> K4 (packed) differs from K4 on the unpacked stages ({dtype})")
        log(f"K5 -> K4 B={batch} {dtype}: gains equal K4 on the unpacked stages bit for bit")
        if dtype == torch.float64:
            log(f"K5 float64 B={batch} H={BATCH_H}: kernel "
                f"{time_ms(lambda: linquad_batched_fused(dyn, cost, xs, us, tile_s=K5_TILE_S), 50):.4f} ms")
        if dtype == torch.float32:
            ms = time_ms(lambda: linquad_batched_fused(dyn, cost, xs, us, tile_s=K5_TILE_S), 50)
            plain_ms = time_ms(lambda: linquad_batched_fused_plain(dyn, cost, xs, us, tile_s=K5_TILE_S), 1)
            b_ms, b_by = bound_ms(k5_work(batch, BATCH_H, 12, 4, 80, dtype), dtype)
            log(f"K5 float32 B={batch} H={BATCH_H}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
                f"bound {b_ms:.2e} ms ({b_by})")
            report[K5] = dict(
                name=K5, route="cuda", source="quattro_tpu_torch/csrc/fused_linquad.cu",
                replaces="quattro_tpu/ops/fused_linquad.py:61", launches=0,
                max_abs_err=max(float((o - r).abs().max()) for o, r in zip(out, ref)),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            )


def phase_k67(report):
    """K6 and K7 (one kernel) against their plain form, lane-wise against K2, and timed (call and queued device
    time) at each batch in float32."""
    from quattro_tpu_torch.ops import fused_riccati as fr
    from quattro_tpu_torch.ops import fused_rollout as fro

    timing = {}
    for batch in BATCHES:
        for dtype in (torch.float64, torch.float32):
            dyn, _, xs, us, (a, b, exp), v_x, v_xx = warm_batch(dtype, batch)
            k, big_k = fr.riccati_backward_batched_fused(a, b, exp, v_x, v_xx, 1e-6)
            alphas = torch.tensor(ALPHAS, dtype=dtype, device="cuda")
            args = (dyn, xs[:, 0], xs, us, k, big_k, alphas)
            ref = fro.fused_feedback_rollouts_batched_plain(*args)
            bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
            outs = {}
            for name, fn in ((K7, fro.fused_feedback_rollouts_batched), (K6, fro.fused_feedback_rollouts_batched2d)):
                outs[name] = fn(*args)
                torch.cuda.synchronize()
                check(f"{name} A=6 B={batch} {dtype}", rel_errs(("cand_x", "cand_u"), outs[name], ref), bound)
            for lane in (0, batch // 2, batch - 1):
                k2 = fro.fused_feedback_rollouts(dyn, xs[lane, 0], xs[lane], us[lane], k[lane], big_k[lane], alphas)
                if not all(torch.equal(c, o[:, lane]) for c, o in zip(k2, outs[K7])):
                    raise AssertionError(f"batched rollout lane {lane} (B={batch}, {dtype}) differs from K2")
            log(f"K6/K7 B={batch} {dtype}: lanes 0, {batch // 2}, {batch - 1} equal K2 bit for bit")
            if dtype != torch.float32:
                continue
            plain_ms = time_ms(lambda: fro.fused_feedback_rollouts_batched_plain(*args), 1)
            b_ms, b_by = bound_ms(k6_work(batch, BATCH_H, len(ALPHAS), dtype), dtype)
            for name, fn, line in ((K6, fro.fused_feedback_rollouts_batched2d, 150),
                                   (K7, fro.fused_feedback_rollouts_batched, 374)):
                ms = time_ms(lambda: fn(*args), 50)
                dev_ms, queued = queued_ms(lambda: fn(*args), 20)
                timing.setdefault(batch, {})[name] = dict(call_ms=ms, queued_ms=dev_ms, queued=queued)
                log(f"{name} float32 A=6 B={batch} H={BATCH_H}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms"
                    f"{QUEUED[queued]}), plain {plain_ms:.1f} ms, bound {b_ms:.2e} ms ({b_by})")
                if batch == BATCHES[-1]:
                    report[name] = dict(
                        name=name, route="cuda", source="quattro_tpu_torch/csrc/fused_rollout_batched.cu",
                        replaces=f"quattro_tpu/ops/fused_rollout.py:{line}", launches=0,
                        max_abs_err=max(float((o - r).abs().max()) for o, r in zip(outs[name], ref)),
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    )
    return timing


def k8_work(batch, m, r, dtype):
    """(bytes, flops) of a batched SPD solve: a and b read once, x written once."""
    size = torch.finfo(dtype).bits // 8
    factor = sum(2 * j + (m - j - 1) * (2 * j + 1) + 2 for j in range(m))  # Cholesky-Crout with sqrt and 1/L_jj
    solve = 2 * r * m * m  # forward and back substitution per right-hand side
    return batch * (m * m + 2 * m * r) * size, batch * (factor + solve)


def spd_batch(batch, m, r, dtype, seed=0):
    """Random SPD systems made on the card from a seeded generator: a = w w' + 2 I, b normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(batch, m, m, generator=gen, device="cuda", dtype=dtype)
    a = w @ w.transpose(-1, -2) + 2.0 * torch.eye(m, dtype=dtype, device="cuda")
    return a, torch.randn(batch, m, r, generator=gen, device="cuda", dtype=dtype)


def phase_k8(report):
    """K8 against its plain form at the suite's and the main path's shapes; timed beside torch.linalg.solve."""
    import ctypes

    from quattro_tpu_torch.ops import _build
    from quattro_tpu_torch.ops.smallchol import batched_cholesky_solve_fused, batched_cholesky_solve_plain

    bare_fn = _build.bind(K8, "qt_batched_cholesky", ctypes.c_int,
                          [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    for batch, r, dtype in K8_SHAPES:
        a, b = spd_batch(batch, 4, r, dtype)
        out = batched_cholesky_solve_fused(a, b)
        ref = batched_cholesky_solve_plain(a, b)
        torch.cuda.synchronize()
        bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
        label = f"K8 B={batch} m=4 r={r} {dtype}"
        check(label, rel_errs(("x",), (out,), (ref,)), bound)
        if batch < 65536:
            continue
        x = torch.empty_like(b)
        args = (0 if dtype == torch.float32 else 1, batch, 4, r, a.data_ptr(), b.data_ptr(), x.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        bare = lambda: bare_fn(*args)
        if bare() != 0:
            raise AssertionError("K8: the bare entry point reported an error")
        library = lambda: torch.linalg.solve(a, b)
        ms, library_ms = in_turns(lambda: batched_cholesky_solve_fused(a, b), library, 20)
        (kernel_ms, queued), (library_dev_ms, library_queued) = queued_ms(bare, 20), queued_ms(library, 20)
        plain_ms = time_ms(lambda: batched_cholesky_solve_plain(a, b), 3)
        b_ms, b_by = bound_ms(k8_work(batch, 4, r, dtype), dtype)
        log(f"{label}: call {ms:.4f} ms, kernel only {kernel_ms:.4f} ms{QUEUED[queued]}; torch.linalg.solve call "
            f"{library_ms:.4f} ms, device {library_dev_ms:.4f} ms{QUEUED[library_queued]}; plain {plain_ms:.3f} ms; "
            f"bound {b_ms:.2e} ms ({b_by}), {b_ms / kernel_ms:.1%} of it; {batch / kernel_ms * 1e3:.3e} systems/s")
        if (batch, r, dtype) == K8_MAIN:
            report[K8] = dict(
                name=K8, route="cuda", source="quattro_tpu_torch/csrc/batched_cholesky.cu",
                replaces="quattro_tpu/ops/smallchol.py:101", launches=0,
                max_abs_err=float((out - ref).abs().max()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            )


def k9_work(num_blocks, n, dtype):
    """(bytes, flops) of the block-tridiagonal SpMV: the N diagonal and N - 1 lower blocks and x read
    once, y written once; each lower block is used twice (L and L^T), so 3N - 2 block products."""
    size = torch.finfo(dtype).bits // 8
    nbytes = ((2 * num_blocks - 1) * n * n + 2 * num_blocks * n) * size
    return nbytes, 2 * (3 * num_blocks - 2) * n * n


def phase_k9(report):
    """K9 against its plain form at the suite's and the main path's shapes; timed beside one stacked-band bmm."""
    import ctypes

    from quattro_tpu_torch.ops import _build
    from quattro_tpu_torch.ops.blocktridiag import (
        BlockTridiagonal, btd_matvec_fused, btd_matvec_plain, kkt_residual,
    )

    bare_fn = _build.bind(K9, "qt_btd_matvec", ctypes.c_int,
                          [ctypes.c_int, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6)
    n = 12
    for num_blocks, dtype in K9_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(num_blocks)
        mat = BlockTridiagonal(torch.randn(num_blocks, n, n, generator=gen, device="cuda", dtype=dtype),
                               torch.randn(num_blocks - 1, n, n, generator=gen, device="cuda", dtype=dtype))
        x = torch.randn(num_blocks, n, generator=gen, device="cuda", dtype=dtype)
        rhs = torch.randn(num_blocks, n, generator=gen, device="cuda", dtype=dtype)
        out = btd_matvec_fused(mat, x)
        res = kkt_residual(mat, x, rhs)
        ref = btd_matvec_plain(mat, x)
        torch.cuda.synchronize()
        bound = F64_KERNEL_REL if dtype == torch.float64 else F32_KERNEL_REL
        label = f"K9 N={num_blocks} n={n} {dtype}"
        check(label, rel_errs(("y", "residual"), (out, res), (ref, (ref - rhs).abs().amax(-1))), bound)
        # The library yardstick: the contraction of the TPU kernel's body, one torch.bmm of the band
        # stacked as [L_{t-1} | D_t | L_t^T] (N, n, 3n) against [x_{t-1}; x_t; x_{t+1}] (N, 3n, 1).
        # The stacking is done once, outside the timed call.
        zero_b, zero_v = mat.diag.new_zeros((1, n, n)), x.new_zeros((1, n))
        band = torch.cat([torch.cat([zero_b, mat.lower]), mat.diag,
                          torch.cat([mat.lower.transpose(-1, -2), zero_b])], dim=-1).contiguous()
        x_sta = torch.cat([torch.cat([zero_v, x[:-1]]), x, torch.cat([x[1:], zero_v])], dim=-1)[..., None].contiguous()
        lib_err = float((torch.bmm(band, x_sta)[..., 0] - ref).abs().max() / ref.abs().max())
        library = lambda: torch.bmm(band, x_sta)
        y = torch.empty_like(x)
        args = (0 if dtype == torch.float32 else 1, num_blocks, n, mat.diag.data_ptr(), mat.lower.data_ptr(),
                x.data_ptr(), None, y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        bare = lambda: bare_fn(*args)
        if bare() != 0:
            raise AssertionError("K9: the bare entry point reported an error")
        ms, library_ms = in_turns(lambda: btd_matvec_fused(mat, x), library, 50)
        (kernel_ms, queued), (library_dev_ms, library_queued) = queued_ms(bare, 50), queued_ms(library, 50)
        residual_ms = min(time_ms(lambda: kkt_residual(mat, x, rhs), 50) for _ in range(3))
        plain_ms = time_ms(lambda: btd_matvec_plain(mat, x), 10)
        b_ms, b_by = bound_ms(k9_work(num_blocks, n, dtype), dtype)
        log(f"{label}: call {ms:.4f} ms, kernel only {kernel_ms:.4f} ms{QUEUED[queued]} "
            f"({mat.block_nnz / kernel_ms * 1e3:.3e} block-nnz/s); stacked-band bmm call {library_ms:.4f} ms, device "
            f"{library_dev_ms:.4f} ms{QUEUED[library_queued]} (rel err {lib_err:.1e}; stacking not timed); "
            f"kkt_residual call {residual_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {b_ms:.2e} ms ({b_by}), "
            f"{b_ms / kernel_ms:.1%} of it")
        if (num_blocks, dtype) == K9_MAIN:
            report[K9] = dict(
                name=K9, route="cuda", source="quattro_tpu_torch/csrc/btd_matvec.cu",
                replaces="quattro_tpu/ops/blocktridiag.py:80", launches=0, max_abs_err=float((out - ref).abs().max()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            )


def random_lq(horizon, dtype, seed=0, n=12, m=4):
    """benchmarks/suite.py's ``random_lq_problem`` for one trajectory (``latency_scale``), from a numpy seed."""
    from quattro_tpu_torch.solver import CostExpansion

    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device="cuda")
    a = np.eye(n) + 0.01 * rng.standard_normal((horizon, n, n))
    b = 0.05 * rng.standard_normal((horizon, n, m))
    w = rng.standard_normal((horizon, n, n))
    exp = CostExpansion(
        l_x=t(rng.standard_normal((horizon, n))), l_u=t(rng.standard_normal((horizon, m))),
        l_xx=t(0.1 * w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(n)),
        l_uu=t(np.broadcast_to(np.eye(m), (horizon, m, m)).copy()),
        l_ux=t(0.01 * rng.standard_normal((horizon, m, n))),
    )
    v_x = rng.standard_normal(n)
    wf = rng.standard_normal((n, n))
    return t(a), t(b), exp, t(v_x), t(wf @ wf.T + np.eye(n))


def to_cpu(stages):
    from quattro_tpu_torch.solver import CostExpansion

    a, b, exp, v_x, v_xx = stages
    return a.cpu(), b.cpu(), CostExpansion(*(e.cpu() for e in exp)), v_x.cpu(), v_xx.cpu()


def within(out, ref, rtol, atol):
    return bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())


def kkt_route(stages, reg):
    """build_lqr_kkt -> btd_solve -> recover_primal -> kkt_residual."""
    from quattro_tpu_torch.ops.blocktridiag import btd_solve, build_lqr_kkt, kkt_residual, recover_primal

    system = build_lqr_kkt(*stages, reg=reg)
    lam = btd_solve(system.matrix, system.rhs)
    return system, lam, recover_primal(system, lam), kkt_residual(system.matrix, lam, system.rhs)


def newton_step(stages, reg):
    """K1's gains rolled through the linearized dynamics: dx_1..dx_H of the Riccati Newton step."""
    from quattro_tpu_torch.solver import riccati_backward_fused

    a, b, exp, v_x, v_xx = stages
    res = riccati_backward_fused(a, b, exp, v_x, v_xx, reg)
    dx, out = a.new_zeros(a.shape[-1]), []
    for t in range(a.shape[0]):
        dx = a[t] @ dx + b[t] @ (res.k_seq[t] + res.big_k_seq[t] @ dx)
        out.append(dx)
    return torch.stack(out)


def phase_assoc(report, pure_xs):
    """The associative Riccati form (two K8 launches per pass) and the KKT route (K9) through public entry points."""
    from quattro_tpu_torch.control import make_quadrotor_mpc
    from quattro_tpu_torch.parallel import batched_ilqr_solve
    from quattro_tpu_torch.solver import (
        ILQRConfig, ilqr_solve, linearize_dynamics, quadratize_cost, quadratize_final_cost, riccati_backward,
        riccati_backward_associative, riccati_backward_fused,
    )
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    results = {}
    # The pass in float64: the card against the same call on the CPU (K8's plain form there), and
    # against K1 at JAX's tolerance for the two forms.
    problems = {"bench H=100": lambda dt: bench_stages(dt)[1], "random LQ H=1024": lambda dt: random_lq(1024, dt)}
    for label, make in problems.items():
        stages = make(torch.float64)
        out, counts = counted((K8,), report, lambda: riccati_backward_associative(*stages, 1e-6))
        ref = riccati_backward_associative(*to_cpu(stages), 1e-6)
        check(f"assoc pass {label} float64, card against CPU", rel_errs(("k", "K", "V_x", "V_xx"),
                                                                       [o.cpu() for o in out], ref), F64_KERNEL_REL)
        k1 = riccati_backward_fused(*stages, 1e-6)
        near = within(out.k_seq, k1.k_seq, ASSOC_K1_RTOL, ASSOC_K1_ATOL) and within(
            out.big_k_seq, k1.big_k_seq, ASSOC_K1_RTOL, ASSOC_K1_ATOL)
        log(f"assoc pass {label} float64: launches {counts}; gains within rtol {ASSOC_K1_RTOL}, atol {ASSOC_K1_ATOL} "
            f"of K1: {near} (max |dk| {float((out.k_seq - k1.k_seq).abs().max()):.2e})")
        if counts != {K8: 2} or not near:
            raise AssertionError(f"assoc pass {label}: launches {counts}, gains near K1 {near}")

    # Timing in float32: the pass beside K1 and the sequential form (the data behind riccati_backward_auto).
    timing = {}
    for label, stages in (("H=50", bench_stages(torch.float32, 50)[1]), ("H=100", bench_stages(torch.float32)[1]),
                          ("H=1024", random_lq(1024, torch.float32))):
        horizon = stages[0].shape[0]
        assoc_ms = time_ms(lambda: riccati_backward_associative(*stages, 1e-6), 3)
        k1_ms = time_ms(lambda: riccati_backward_fused(*stages, 1e-6), 20)
        seq_ms = time_ms(lambda: riccati_backward(*stages, 1e-6), 1)
        nnz = 3 * horizon - 2  # block-nnz of the trajectory's dual-Schur KKT matrix
        timing[label] = dict(assoc_ms=assoc_ms, k1_ms=k1_ms, seq_ms=seq_ms, assoc_block_nnz_per_s=nnz / assoc_ms * 1e3)
        log(f"assoc pass float32 {label}: associative {assoc_ms:.3f} ms ({nnz / assoc_ms * 1e3:.3e} block-nnz/s), "
            f"K1 {k1_ms:.4f} ms, sequential {seq_ms:.2f} ms")
    results["pass_float32"] = timing

    # A solve through it: the bench problem, float64, card against CPU.
    dyn, cost, fcost, x0, u0 = bench_problem(torch.float64)
    cfg = ILQRConfig(tol=0.0, max_iter=6, riccati="assoc", linesearch="fused")
    sol, counts = counted((K8, K2), report, lambda: ilqr_solve(dyn, cost, fcost, x0, u0, cfg))
    ref = ilqr_solve(*bench_problem(torch.float64, device="cpu"), cfg)
    cost_rel = abs(float(sol.cost) - float(ref.cost)) / abs(float(ref.cost))
    log(f"assoc solve (bench problem, float64, 6 forced iterations): iterations {sol.iterations} (CPU {ref.iterations}), "
        f"converged {sol.converged} (CPU {ref.converged}), cost {float(sol.cost):.10f} rel {cost_rel:.2e} against the "
        f"CPU run, launches {counts}")
    if (sol.iterations, sol.converged) != (ref.iterations, ref.converged) or not cost_rel <= F64_BATCH_COST_RTOL \
            or counts.get(K8) != 2 * sol.iterations:
        raise AssertionError("assoc solve on the card disagrees with the CPU run")
    results["solve_cost_rel"] = cost_rel

    # The MPC loop with riccati="assoc", held to the K1 pure loop's state at the same step.
    plant = make_discrete(QuadrotorField(), 0.01, "rk4")
    ctrl = make_quadrotor_mpc(horizon=50, riccati="assoc")
    loop, counts = counted((K8, K2), report, lambda: closed_loop(
        ctrl.step, ctrl.init_state(), plant, quadrotor_start(torch.device("cuda")), ASSOC_MPC_STEPS))
    track = float((loop.x - pure_xs[ASSOC_MPC_STEPS - 1]).abs().max())
    median_ms, p99_ms = latency(loop.lat)
    log(f"MPC assoc: {ASSOC_MPC_STEPS} steps, max |x - x(K1 pure loop)| {track:.3e} (bar {HYBRID_TRACK_BAR}), step "
        f"latency median {median_ms:.2f} ms p99 {p99_ms:.2f} ms, launches {counts}")
    if not (track < HYBRID_TRACK_BAR and torch.isfinite(loop.x_plan).all() and counts.get(K1, 0) == 0):
        raise AssertionError(f"MPC assoc left the K1 pure loop: {track}, launches {counts}")
    results["mpc"] = dict(track=track, median_ms=median_ms, p99_ms=p99_ms)

    # The batched solve, "vmap" backend with the associative form batched: two K8 launches per trip.
    assoc_cfg = ILQRConfig(tol=0.0, max_iter=BATCH_ITERS, riccati="assoc")
    for dtype, batch in [(torch.float32, width) for width in BATCHES] + [(torch.float64, BATCHES[0])]:
        problem = suite_batch(dtype, batch)
        solve = functools.partial(batched_ilqr_solve, *problem, assoc_cfg, riccati_backend="vmap")
        sol, counts = counted((K8,), report, solve)
        trips = int(sol.iterations.max())
        if trips != BATCH_ITERS or counts != {K8: 2 * trips} or not torch.isfinite(sol.cost).all():
            raise AssertionError(f"batched assoc solve B={batch} {dtype}: {trips} trips, launches {counts}")
        if dtype == torch.float32:
            start = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            results[f"batched_B{batch}"] = dict(seconds=seconds, solves_per_s=batch / seconds)
            log(f"batched assoc solve B={batch} float32: {seconds:.3f} s, {batch / seconds:.1f} solves/s, "
                f"launches {counts} ({batch * BATCH_H} systems per K8 launch)")
            continue
        dyn, cost, fcost, x0, u0 = problem
        worst = dict(cost=0.0, u=0.0)
        for lane in (0, batch // 2, batch - 1):
            one = ilqr_solve(dyn, cost, fcost, x0[lane], u0[lane], assoc_cfg)
            same = (one.iterations == int(sol.iterations[lane]) and one.converged == bool(sol.converged[lane]))
            worst["cost"] = max(worst["cost"], abs(float(one.cost) - float(sol.cost[lane])) / abs(float(one.cost)))
            worst["u"] = max(worst["u"], float((one.u_seq - sol.u_seq[lane]).abs().max()))
            if not same:
                raise AssertionError(f"batched assoc lane {lane}: iterations/flags differ from its single solve")
        log(f"batched assoc solve B={batch} float64: lanes 0, {batch // 2}, {batch - 1} against ilqr_solve of that lane: "
            f"equal iterations and flags, cost rel {worst['cost']:.2e} (bound {F64_BATCH_COST_RTOL}), max |du| "
            f"{worst['u']:.2e} (bound {F64_BATCH_U_ATOL})")
        if not (worst["cost"] <= F64_BATCH_COST_RTOL and worst["u"] <= F64_BATCH_U_ATOL):
            raise AssertionError(f"batched assoc solve: lanes differ from their single solves: {worst}")
        results["batched_lanes_f64"] = worst

    # The KKT route, float64: the bench problem's LQ subproblem about its K1/K2 solve, and the random LQ problem.
    dyn, cost, fcost, x0, u0 = bench_problem(torch.float64)
    sol = ilqr_solve(dyn, cost, fcost, x0, u0, ILQRConfig(tol=0.0, max_iter=6, riccati="fused", linesearch="fused"))
    a, b = linearize_dynamics(dyn, sol.x_seq, sol.u_seq)
    fin = quadratize_final_cost(fcost, sol.x_seq[-1])
    subproblems = {"bench H=100": (a, b, quadratize_cost(cost, sol.x_seq, sol.u_seq), fin.v_x, fin.v_xx),
                   "random LQ H=1024": random_lq(1024, torch.float64)}
    for label, stages in subproblems.items():
        start = time.perf_counter()
        (system, lam, dx, res), counts = counted((K9,), report, lambda: kkt_route(stages, 1e-9))
        route_s = time.perf_counter() - start
        scale = float(system.rhs.abs().max())
        dx_newton = newton_step(stages, 1e-9)
        cpu = kkt_route(to_cpu(stages), 1e-9)
        card_cpu = rel_errs(("lam", "dx"), (lam.cpu(), dx.cpu()), cpu[1:3])
        res_rel = float(res.max()) / scale
        matches = within(dx, dx_newton, KKT_DX_RTOL, KKT_DX_ATOL)
        nnz = system.matrix.block_nnz
        log(f"KKT route {label} float64: {nnz} block-nnz, residual {res_rel:.2e} of the rhs scale (bound "
            f"{KKT_RESIDUAL_REL}); dx equals the Riccati Newton step from K1 (rtol {KKT_DX_RTOL}, atol {KKT_DX_ATOL}): "
            f"{matches} (max |d dx| {float((dx - dx_newton).abs().max()):.2e}); card against CPU {card_cpu} "
            f"(bound {F64_KERNEL_REL}); launches {counts}; {route_s:.2f} s for the route")
        check(f"KKT route {label}, card against CPU", card_cpu, F64_KERNEL_REL)
        if not (res_rel < KKT_RESIDUAL_REL and matches and counts.get(K9, 0) >= 1):
            raise AssertionError(f"KKT route {label}: residual {res_rel}, Newton step {matches}, launches {counts}")
        results[f"kkt_{label}"] = dict(residual_rel=res_rel, seconds=route_s, block_nnz=nnz)
    return results


def counted(kernels, report, fn):
    """Run one main-path run with the counters zeroed; fail if a kernel of it did not launch."""
    from quattro_tpu_torch.ops import _build

    _build.reset_launches()
    result = fn()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    for name in kernels:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path (counts {counts})")
    for name, count in counts.items():
        report[name]["launches"] += count
    return result, counts


def phase_bench(report):
    from quattro_tpu_torch.solver import ILQRConfig, ilqr_solve

    dyn, cost, fcost, x0, u0 = bench_problem(torch.float32)
    fused_cfg = ILQRConfig(tol=0.0, max_iter=6, riccati="fused", linesearch="fused")
    seq_cfg = ILQRConfig(tol=0.0, max_iter=6, riccati="seq", linesearch="xla")
    fused, counts = counted((K1, K2), report, lambda: ilqr_solve(dyn, cost, fcost, x0, u0, fused_cfg))
    log(f"bench solve launches: {counts}")
    seq = ilqr_solve(dyn, cost, fcost, x0, u0, seq_cfg)
    for sol in (fused, seq):
        if sol.iterations != 6 or not torch.isfinite(sol.x_seq).all() or sol.x_seq.shape != (101, 12):
            raise AssertionError(f"bench solve malformed: iterations {sol.iterations}")
    cost_rel = abs(float(fused.cost) - float(seq.cost)) / abs(float(seq.cost))
    u_abs = float((fused.u_seq - seq.u_seq).abs().max())
    log(f"bench: cost fused {float(fused.cost):.6f} seq {float(seq.cost):.6f} rel {cost_rel:.3e} "
        f"(bound {F32_SOLVE_COST_REL}); max |du| {u_abs:.3e} (bound {F32_SOLVE_U_ABS})")
    if not (cost_rel <= F32_SOLVE_COST_REL and u_abs <= F32_SOLVE_U_ABS):
        raise AssertionError("fused bench solve disagrees with the seq/xla solve")
    rates = {}
    for label, cfg in (("fused", fused_cfg), ("seq_xla", seq_cfg)):
        ms = time_ms(lambda: ilqr_solve(dyn, cost, fcost, x0, u0, cfg), 1, warm=False)  # the solves above warmed both
        rates[label] = 6.0 / (ms / 1e3)
        log(f"bench {label}: {ms:.2f} ms per 6-iteration solve, {rates[label]:.1f} iterations/s")
    return rates


def phase_batch(report):
    """The batched solve at the suite's problem: each backend, launches per trip, parity, solves/s."""
    from quattro_tpu_torch.parallel import batched_ilqr_solve
    from quattro_tpu_torch.solver import ILQRConfig

    forced = ILQRConfig(tol=0.0, max_iter=BATCH_ITERS)
    runs = (
        ("fused", forced, "fused", (K4,)),
        ("fused_ls", forced._replace(linesearch="fused"), "fused", (K4, K7)),
        ("fused_bf16", forced, "fused_bf16", (K4,)),
        ("vmap", forced, "vmap", ()),
    )
    results = {}
    for dtype, batches in ((torch.float64, BATCHES[:1]), (torch.float32, BATCHES)):
        for batch in batches:
            problem = suite_batch(dtype, batch)
            sols = {}
            for label, cfg, backend, kernels in runs:
                if dtype == torch.float64 and label not in ("fused", "vmap"):
                    continue
                solve = functools.partial(batched_ilqr_solve, *problem, cfg, riccati_backend=backend)
                sol, counts = counted(kernels, report, solve)
                trips = int(sol.iterations.max())
                timing = ""
                if dtype == torch.float32:  # a second, warm call, synchronized, on the host clock
                    start = time.perf_counter()
                    solve()
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - start
                    results[f"{label}_B{batch}"] = dict(seconds=seconds, solves_per_s=batch / seconds)
                    timing = f"{seconds:.3f} s, {batch / seconds:.1f} solves/s, "
                log(f"batched solve {label} B={batch} {dtype}: {timing}{trips} trips, launches {counts}, "
                    f"mean cost {float(sol.cost.mean()):.6f}")
                if trips != BATCH_ITERS or counts != {name: trips for name in kernels}:
                    raise AssertionError(f"batched solve {label}: {trips} trips, launches {counts}; expected "
                                         f"{BATCH_ITERS} trips and one launch of each of {kernels} per trip")
                if not (torch.isfinite(sol.x_seq).all() and sol.x_seq.shape == (batch, BATCH_H + 1, 12)
                        and torch.isfinite(sol.cost).all()):
                    raise AssertionError(f"batched solve {label} B={batch} {dtype}: malformed solution")
                sols[label] = sol
            fused, vmap_sol = sols["fused"], sols["vmap"]
            same_flags = bool(torch.equal(fused.iterations, vmap_sol.iterations)
                              and torch.equal(fused.converged, vmap_sol.converged))
            cost_rel = float(((fused.cost - vmap_sol.cost).abs() / vmap_sol.cost.abs()).max())
            u_abs = float((fused.u_seq - vmap_sol.u_seq).abs().max())
            if dtype == torch.float64:
                log(f"batched solve B={batch} float64, fused against vmap: iterations/converged equal {same_flags}, "
                    f"cost rel {cost_rel:.3e} (bound {F64_BATCH_COST_RTOL}), max |du| {u_abs:.3e} "
                    f"(bound {F64_BATCH_U_ATOL})")
                if not (same_flags and cost_rel <= F64_BATCH_COST_RTOL and u_abs <= F64_BATCH_U_ATOL):
                    raise AssertionError("float64 batched solve: fused and vmap backends disagree")
                continue
            one = ILQRConfig(tol=0.0, max_iter=1)
            one_rel = float(((batched_ilqr_solve(*problem, one, riccati_backend="fused").cost
                              - batched_ilqr_solve(*problem, one, riccati_backend="vmap").cost).abs()
                             / fused.cost.abs()).max())
            agree = ((fused.iterations == vmap_sol.iterations)
                     & ((fused.cost - vmap_sol.cost).abs() <= F32_SOLVE_COST_REL * vmap_sol.cost.abs()))
            share = float(agree.float().mean())
            bf16_rel = float(((sols["fused_bf16"].cost - fused.cost).abs() / fused.cost.abs()).max())
            ls_rel = float(((sols["fused_ls"].cost - fused.cost).abs() / fused.cost.abs()).max())
            log(f"batched solve B={batch} float32, fused against vmap: max cost rel after 1 iteration {one_rel:.3e}; "
                f"after {BATCH_ITERS}: share of lanes with equal iterations and cost within {F32_SOLVE_COST_REL} "
                f"{share:.4f}, max cost rel {cost_rel:.3e}; fused_ls against fused max cost rel {ls_rel:.3e}; "
                f"fused_bf16 against fused {bf16_rel:.3e} (band {BF16_BAND})")
            if not bf16_rel < BF16_BAND:
                raise AssertionError(f"fused_bf16 solve outside the bf16 band of the exact solve: {bf16_rel}")
            results[f"float32_B{batch}"] = dict(one_iteration_cost_rel=one_rel, agree_share=share,
                                                 cost_rel=cost_rel, fused_ls_cost_rel=ls_rel, bf16_cost_rel=bf16_rel)
    return results


def phase_batch_trip(report):
    """One fully fused batched trip through public entry points: K5 -> K4 (packed) -> line_search_batched2d (K6).

    Held to the first trip of the "fused" backend (torch.func derivatives, K4,
    PyTorch line search) at float32's bound; the device idle share of the trip
    and of one "fused" trip with K7 are read under torch.profiler.
    """
    from torch.func import vmap

    from quattro_tpu_torch.ops.fused_linquad import linquad_batched_fused
    from quattro_tpu_torch.ops.fused_riccati import riccati_backward_batched_fused2d
    from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts_batched2d
    from quattro_tpu_torch.parallel import batched_ilqr_solve
    from quattro_tpu_torch.solver import (
        ILQRConfig, line_search_batched2d, quadratize_final_cost, simulate, trajectory_cost,
    )

    batch = BATCHES[-1]
    dyn, cost, fcost, x0, u0 = suite_batch(torch.float32, batch)
    xs = vmap(functools.partial(simulate, dyn))(x0, u0)
    cs = vmap(functools.partial(trajectory_cost, cost, fcost))(xs, u0)
    alphas = torch.tensor(ALPHAS, device="cuda")

    def trip():
        packed = linquad_batched_fused(dyn, cost, xs, u0, tile_s=K5_TILE_S)
        fin = vmap(functools.partial(quadratize_final_cost, fcost))(xs[:, -1])
        k, big_k = riccati_backward_batched_fused2d(None, None, None, fin.v_x, fin.v_xx, 1e-6, tile_s=K5_TILE_S,
                                                    packed_stage=packed, horizon=BATCH_H)
        return line_search_batched2d(dyn, cost, fcost, x0, xs, u0, k, big_k, cs, alphas)

    (found, _, new_x, _, new_cost), counts = counted((K4, K5, K6), report, trip)
    ref = batched_ilqr_solve(dyn, cost, fcost, x0, u0, ILQRConfig(tol=0.0, max_iter=1), riccati_backend="fused")
    cost_rel = float(((new_cost - ref.cost).abs() / ref.cost.abs()).max())
    # The trip's device time: each of its three kernel calls queued behind a sleep kernel on the trip's inputs.
    packed = linquad_batched_fused(dyn, cost, xs, u0, tile_s=K5_TILE_S)
    fin = vmap(functools.partial(quadratize_final_cost, fcost))(xs[:, -1])
    k, big_k = riccati_backward_batched_fused2d(None, None, None, fin.v_x, fin.v_xx, 1e-6, tile_s=K5_TILE_S,
                                                packed_stage=packed, horizon=BATCH_H)
    kernel_ms = {
        K5: queued_ms(lambda: linquad_batched_fused(dyn, cost, xs, u0, tile_s=K5_TILE_S), 20),
        K4: queued_ms(lambda: riccati_backward_batched_fused2d(None, None, None, fin.v_x, fin.v_xx, 1e-6,
                                                               tile_s=K5_TILE_S, packed_stage=packed,
                                                               horizon=BATCH_H), 20),
        K6: queued_ms(lambda: fused_feedback_rollouts_batched2d(dyn, x0, xs, u0, k, big_k, alphas), 20),
    }
    device_ms = sum(v[0] for v in kernel_ms.values())
    log(f"fused batched trip B={batch}: device time of its kernels "
        + ", ".join(f"{name} {v[0]:.4f} ms{QUEUED[v[1]]}" for name, v in kernel_ms.items())
        + f"; sum {device_ms:.4f} ms")
    trip_ms = wall_ms(trip)
    idle = idle_share(trip)
    one_trip = ILQRConfig(tol=0.0, max_iter=1, linesearch="fused")
    solve_idle = idle_share(lambda: batched_ilqr_solve(dyn, cost, fcost, x0, u0, one_trip, riccati_backend="fused"))
    log(f"fused batched trip K5 -> K4 -> K6, B={batch}: launches {counts}, {int(found.sum())} lanes accepted, "
        f"cost rel against the fused backend's first trip {cost_rel:.3e} (bound {F32_SOLVE_COST_REL}); "
        f"wall {trip_ms:.2f} ms, device idle share (profiled) {idle}; one-trip fused solve with K7, "
        f"idle share {solve_idle}")
    if counts != {K4: 1, K5: 1, K6: 1} or not (torch.isfinite(new_x).all() and cost_rel <= F32_SOLVE_COST_REL):
        raise AssertionError(f"fused batched trip: launches {counts}, cost rel {cost_rel}")
    return dict(trip_ms=trip_ms, idle_share=idle, one_trip_solve_idle_share=solve_idle, cost_rel=cost_rel,
                device_ms=device_ms, kernel_device_ms={name: v[0] for name, v in kernel_ms.items()})


def synced_ms(fn):
    """Host wall time of one call, synchronized before and after (ms)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - start)


def wall_ms(fn, reps=2):
    """Median host wall time of one synchronized call, after one warm-up call."""
    fn()
    return float(np.median([synced_ms(fn) for _ in range(reps)]))


def phase_breakdown(pred, horizon=50):
    """Wall time of each part of one solve iteration at the MPC horizon (float32)."""
    from quattro_tpu_torch.solver import (
        line_search, line_search_fused, linearize_dynamics, quadratize_cost, quadratize_final_cost,
        riccati_backward, riccati_backward_fused, simulate, trajectory_cost,
    )

    dyn, cost, fcost, x0, u0 = bench_problem(torch.float32, horizon)
    u0 += 2.4525
    x_seq = simulate(dyn, x0, u0)
    a, b = linearize_dynamics(dyn, x_seq, u0)
    exp = quadratize_cost(cost, x_seq, u0)
    fin = quadratize_final_cost(fcost, x_seq[-1])
    gains = riccati_backward_fused(a, b, exp, fin.v_x, fin.v_xx, 1e-6)
    current = trajectory_cost(cost, fcost, x_seq, u0)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.05, 0.01], device=x0.device)
    ls_args = (dyn, cost, fcost, x0, x_seq, u0, gains.k_seq, gains.big_k_seq, current, alphas)
    window = pred.prompt_len
    prompt = torch.zeros(window, 52, device=x0.device)
    predict = pred.predict_fn()
    parts = {
        "simulate": lambda: simulate(dyn, x0, u0),
        "trajectory_cost": lambda: trajectory_cost(cost, fcost, x_seq, u0),
        "linearize_dynamics": lambda: linearize_dynamics(dyn, x_seq, u0),
        "quadratize_cost+final": lambda: (quadratize_cost(cost, x_seq, u0), quadratize_final_cost(fcost, x_seq[-1])),
        "riccati K1": lambda: riccati_backward_fused(a, b, exp, fin.v_x, fin.v_xx, 1e-6),
        "riccati seq": lambda: riccati_backward(a, b, exp, fin.v_x, fin.v_xx, 1e-6),
        "line_search K2": lambda: line_search_fused(*ls_args),
        "line_search xla": lambda: line_search(*ls_args),
        "predictor": lambda: predict(x_seq, prompt),
    }
    times = {name: wall_ms(fn) for name, fn in parts.items()}
    log(json.dumps({"breakdown_ms": {"horizon": horizon, **times}}))
    return times


def idle_share(fn):
    """1 - (device kernel time / host wall time) over ``fn`` under torch.profiler.

    Only device activity is traced (tens of thousands of kernels per MPC
    step). The profiler's own host overhead lengthens the wall time, so the
    share is an upper bound. Returns None where the trace holds no device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - start)
    # The device events' durations straight from the trace: the same sum as key_averages()'s self device time
    # of its CUDA events, without building a Python object per traced kernel.
    busy_us = 1e-3 * sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA)
    return None if busy_us <= 0 else 1.0 - busy_us / wall_us


class Loop(NamedTuple):
    x: torch.Tensor  # the plant's last state
    x_plan: torch.Tensor  # the controller's last plan
    lat: list  # step latencies (s)
    state: object  # the controller's state after the last step
    xs: list  # the plant's state after each step


def closed_loop(step, state, plant, x, n_steps):
    """``n_steps`` of controller and plant in turn."""
    lat, xs = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        u, x_plan, state = step(x, state)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        x = plant(x, u)
        xs.append(x)
    return Loop(x, x_plan, lat, state, xs)


def quadrotor_start(dev):
    x = torch.zeros(12, device=dev)
    x[2], x[6] = 0.2, 0.15
    return x


def latency(lat):
    lat_ms = 1e3 * np.asarray(lat)
    return float(np.median(lat_ms)), float(np.percentile(lat_ms, 99))


def phase_megakernel(report):
    """The megakernel MPC path: quadrotor at full width, then the cart-pole (megakernel and blend)."""
    from quattro_tpu_torch.control import MPCState, make_cartpole_mpc, make_quadrotor_mpc, shift_warm_start
    from quattro_tpu_torch.ops.fused_solve import fused_ilqr_solve_kernel
    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost, simulate, trajectory_cost
    from quattro_tpu_torch.systems import CartPoleField, QuadrotorField, make_discrete

    dev = torch.device("cuda")
    results = {}
    plant = make_discrete(QuadrotorField(), 0.01, "rk4")
    x_ref = torch.zeros(12, device=dev)
    x_ref[2] = 0.5
    ctrl = make_quadrotor_mpc(horizon=50, solver="megakernel", max_iter=6)

    def run(n_steps=MPC_STEPS):
        return closed_loop(ctrl.step, ctrl.init_state(), plant, quadrotor_start(dev), n_steps)

    (x, x_plan, lat, state, _), counts = counted((K2, K3), report, run)
    idle = idle_share(lambda: closed_loop(ctrl.step, state, plant, x, IDLE_STEPS))
    err = float((x - x_ref).norm())
    median_ms, p99_ms = latency(lat)
    log(f"MPC megakernel (quadrotor H=50, 6 trips): {MPC_STEPS} steps, ||x - x_ref|| = {err:.3e}, step latency "
        f"median {median_ms:.3f} ms p99 {p99_ms:.3f} ms, launches {counts}, device idle share over the next "
        f"{IDLE_STEPS} steps (profiled) {idle}")
    if counts.get(K3) != MPC_STEPS or counts.get(K1, 0) != 0:
        raise AssertionError(f"MPC megakernel: expected exactly one K3 launch per step and no K1, got {counts}")
    if not (torch.isfinite(x_plan).all() and x_plan.shape == (51, 12)):
        raise AssertionError("MPC megakernel: malformed plan")
    if not err < MPC_ERROR_BAR:
        raise AssertionError(f"MPC megakernel: ||x - x_ref|| = {err} >= {MPC_ERROR_BAR}")
    results["quadrotor"] = dict(err=err, median_ms=median_ms, p99_ms=p99_ms, idle_share=idle)

    # The same step with the eager simulate as the initial rollout (what the
    # JAX entry point does), composed by hand from the port's public pieces.
    t = lambda v: torch.tensor(v, device=dev)
    cost = make_quadratic_cost(t(Q), t([0.01] * 4), x_ref, barrier_alpha=1000.0, barrier_beta=10.0)
    fcost = make_quadratic_final_cost(t(QF), x_ref)

    def step_with_simulate(x, state):
        x_init = simulate(plant, x, state.u_warm)
        cost_init = trajectory_cost(cost, fcost, x_init, state.u_warm)
        x_seq, u_seq, _, _, stats = fused_ilqr_solve_kernel(
            plant, cost, fcost, x_init, state.u_warm, cost_init, 6, 1e-3, 1e-6, ALPHAS)
        stats[0].tolist()  # the solve's one host read
        return u_seq[0], x_seq, MPCState(shift_warm_start(u_seq))

    x_sim, _, lat_sim, _, _ = closed_loop(step_with_simulate, ctrl.init_state(), plant, quadrotor_start(dev), SIMULATE_STEPS)
    x_k2 = run(SIMULATE_STEPS).x
    drift = float((x_sim - x_k2).abs().max())
    sim_median, sim_p99 = latency(lat_sim)
    log(f"MPC megakernel with simulate as the initial rollout: {SIMULATE_STEPS} steps, step latency median "
        f"{sim_median:.3f} ms p99 {sim_p99:.3f} ms; max |x - x(K2 initial rollout)| after them {drift:.3e}")
    if not drift < 1e-5:
        raise AssertionError(f"the two initial rollouts lead to different closed loops: {drift}")
    results["quadrotor_simulate"] = dict(median_ms=sim_median, p99_ms=sim_p99)

    cart_plant = make_discrete(CartPoleField(), 0.01, "rk4")
    for label, kwargs, kernels, bar in (
        ("megakernel", dict(solver="megakernel", max_iter=6), (K2, K3), CARTPOLE_MEGAKERNEL_BAR),
        ("blend", dict(mode="blend"), (K1, K2), CARTPOLE_BLEND_BAR),
    ):
        cart = make_cartpole_mpc(**kwargs)
        (x, x_plan, lat, _, _), counts = counted(
            kernels, report,
            lambda: closed_loop(cart.step, cart.init_state(), cart_plant, t([0.15, 0.0, 0.2, 0.0]), MPC_STEPS))
        err = float(x.norm())
        median_ms, p99_ms = latency(lat)
        log(f"MPC cart-pole {label} (H=30): {MPC_STEPS} steps, ||x|| = {err:.3e} (bar {bar}), step latency median "
            f"{median_ms:.3f} ms p99 {p99_ms:.3f} ms, launches {counts}")
        if label == "megakernel" and counts.get(K3) != MPC_STEPS:
            raise AssertionError(f"cart-pole megakernel: expected one K3 launch per step, got {counts}")
        if not (torch.isfinite(x_plan).all() and x_plan.shape == (31, 4)):
            raise AssertionError(f"MPC cart-pole {label}: malformed plan")
        if not err < bar:
            raise AssertionError(f"MPC cart-pole {label}: ||x|| = {err} >= {bar}")
        results[f"cartpole_{label}"] = dict(err=err, median_ms=median_ms, p99_ms=p99_ms)
    return results


def phase_mpc(report, root):
    from quattro_tpu_torch.control import make_quadrotor_mpc
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    dev = torch.device("cuda")
    pred = GainPredictor.load(os.path.join(root, "checkpoints", "quadrotor_gain.npz"))
    log(f"gain predictor: {pred.num_params()} parameters, prompt {pred.prompt_len}, target {pred.target_len}")
    phase_breakdown(pred)
    plant = make_discrete(QuadrotorField(), 0.01, "rk4")
    x_ref = torch.zeros(12, device=dev)
    x_ref[2] = 0.5
    results, pure_xs = {}, None
    for mode, n_steps in (("ilqr", MPC_STEPS), ("hybrid", HYBRID_STEPS)):
        kwargs = dict(predict_fn=pred.predict_fn(), prompt_len=pred.prompt_len) if mode == "hybrid" else {}
        ctrl = make_quadrotor_mpc(horizon=50, mode=mode, **kwargs)
        (x, x_plan, lat, state, xs), counts = counted(
            (K1, K2), report,
            lambda: closed_loop(ctrl.step, ctrl.init_state(), plant, quadrotor_start(dev), n_steps))
        idle = idle_share(lambda: closed_loop(ctrl.step, state, plant, x, IDLE_STEPS))
        err = float((x - x_ref).norm())
        median_ms, p99_ms = latency(lat)
        log(f"MPC {mode}: {n_steps} steps, ||x - x_ref|| = {err:.3e}, step latency median "
            f"{median_ms:.2f} ms p99 {p99_ms:.2f} ms (first step {1e3 * lat[0]:.0f} ms, all {sum(lat):.1f} s), launches {counts}, "
            f"device idle share over the next {IDLE_STEPS} steps (profiled) {idle}")
        if not (torch.isfinite(x_plan).all() and x_plan.shape == (51, 12)):
            raise AssertionError(f"MPC {mode}: malformed plan")
        results[mode] = dict(steps=n_steps, err=err, median_ms=median_ms, p99_ms=p99_ms, idle_share=idle)
        if mode == "ilqr":
            pure_xs = xs
            if not err < MPC_ERROR_BAR:
                raise AssertionError(f"MPC {mode}: ||x - x_ref|| = {err} >= {MPC_ERROR_BAR}")
        else:
            track = float((x - pure_xs[n_steps - 1]).abs().max())
            log(f"MPC hybrid: max |x - x(pure)| after {n_steps} steps {track:.3e} (bar {HYBRID_TRACK_BAR})")
            if not track < HYBRID_TRACK_BAR:
                raise AssertionError(f"MPC hybrid left the pure closed loop: {track} >= {HYBRID_TRACK_BAR}")
            results[mode]["track"] = track
    return results, pure_xs


def quadrotor_lhs_states(num, dtype, seed=0):
    """``num`` quadrotor initial states: poses (x, y, z, roll, pitch, yaw) from the "reference" LHS envelope."""
    from quattro_tpu_torch.training import lhs_initial_states

    lower, upper = (torch.tensor(v, dtype=torch.float64, device="cuda") for v in TRAIN_ENVELOPE)
    pose = lhs_initial_states(torch.Generator(device="cuda").manual_seed(seed), lower, upper, num)
    x0 = torch.zeros(num, 12, dtype=torch.float64, device="cuda")
    x0[:, 0:3], x0[:, 6:9] = pose[:, 0:3], pose[:, 3:6]
    return x0.to(dtype)


def phase_train(report, pure_xs):
    """The training path: logged collection (K4 and K7 every trip), the gain-predictor trainer, the new predictor's loop."""
    from quattro_tpu_torch.control import make_quadrotor_mpc
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.parallel import batched_ilqr_solve_with_logs
    from quattro_tpu_torch.solver import ILQRConfig
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete
    from quattro_tpu_torch.training import TrainConfig, collect_gain_dataset, train_gain_predictor
    from quattro_tpu_torch.training.train import _fit_normalizer_flat, _make_optimizer, _split_tokens, _train_step
    from quattro_tpu_torch.io import native_available

    if not native_available():
        raise AssertionError("shard IO: the native (C++) library is not the active backend")
    torch.cuda.reset_peak_memory_stats()
    results = {}
    config = ILQRConfig(tol=1e-3, max_iter=TRAIN_MAX_ITER, linesearch="fused")
    dyn, cost, fcost, _, _ = bench_problem(torch.float32, TRAIN_H)
    x0 = quadrotor_lhs_states(TRAIN_BATCH, torch.float32)

    def collect():
        return collect_gain_dataset(dyn, cost, fcost, x0, TRAIN_H, 4, TRAIN_SIM_STEPS, config,
                                    compact_iters=TRAIN_COMPACT, device_resident=True)

    start = time.perf_counter()
    ds, counts = counted((K4, K7), report, collect)
    seconds = time.perf_counter() - start
    stats = ds.stats
    log(f"collection B={TRAIN_BATCH} H={TRAIN_H} {TRAIN_SIM_STEPS} steps float32: rows kept {stats.rows_kept}, "
        f"valid {stats.rows_valid}, dropped {stats.rows_dropped} ({stats.dropped_fraction:.4f}); {stats.trips} trips, "
        f"launches {counts}; {seconds:.3f} s, {stats.rows_kept / seconds:.1f} rows/s")
    if counts != {K4: stats.trips, K7: stats.trips}:
        raise AssertionError(f"collection: launches {counts}, expected one K4 and one K7 per trip ({stats.trips})")
    if not (len(ds) == stats.rows_kept > 0 and torch.isfinite(ds.x_flat).all() and torch.isfinite(ds.kk_flat).all()
            and ds.x_row_shape == (TRAIN_H + 1, 12) and ds.kk_row_shape == (TRAIN_H, 52)):
        raise AssertionError("collection: malformed rows")
    step_idle = idle_share(lambda: collect_gain_dataset(dyn, cost, fcost, x0, TRAIN_H, 4, 1, config,
                                                        compact_iters=TRAIN_COMPACT, device_resident=True))
    results["collect"] = dict(seconds=seconds, rows_per_s=stats.rows_kept / seconds, rows_kept=stats.rows_kept,
                              rows_valid=stats.rows_valid, rows_dropped=stats.rows_dropped, trips=stats.trips,
                              k4_per_step=stats.trips / TRAIN_SIM_STEPS, step_idle_share=step_idle)

    # float64: the fused backend (K4) against "vmap", on the first control step's logs and on the whole collection.
    dyn64, cost64, fcost64, _, _ = bench_problem(torch.float64, TRAIN_H)
    x64 = quadrotor_lhs_states(PARITY_BATCH, torch.float64)
    u64 = torch.zeros(PARITY_BATCH, TRAIN_H, 4, dtype=torch.float64, device="cuda")
    step_logs = {b: batched_ilqr_solve_with_logs(dyn64, cost64, fcost64, x64, u64, config, riccati_backend=b)[1]
                 for b in ("fused", "vmap")}
    same_valid = bool(torch.equal(step_logs["fused"].valid, step_logs["vmap"].valid))
    sets = {b: collect_gain_dataset(dyn64, cost64, fcost64, x64, TRAIN_H, 4, PARITY_STEPS, config,
                                    riccati_backend=b) for b in ("fused", "vmap")}
    fused, vmap_ds = sets["fused"], sets["vmap"]
    same_rows = fused.x_data.shape == vmap_ds.x_data.shape and fused.stats == vmap_ds.stats
    x_rel = rel_err(torch.from_numpy(fused.x_data), torch.from_numpy(vmap_ds.x_data)) if same_rows else float("inf")
    kk_rel = rel_err(torch.from_numpy(fused.kk_data), torch.from_numpy(vmap_ds.kk_data)) if same_rows else float("inf")
    log(f"collection float64 B={PARITY_BATCH} {PARITY_STEPS} steps, fused against vmap: first step's valid masks "
        f"equal {same_valid}, rows {fused.x_data.shape[0]} and {vmap_ds.x_data.shape[0]}, x rel {x_rel:.3e} (bound "
        f"{PARITY_X_REL}), gain tokens rel {kk_rel:.3e} (bound {PARITY_KK_REL})")
    if not (same_valid and same_rows and x_rel <= PARITY_X_REL and kk_rel <= PARITY_KK_REL):
        raise AssertionError("float64 collection: the fused and vmap backends disagree")
    results["float64_parity"] = dict(x_rel=x_rel, kk_rel=kk_rel, rows=int(fused.x_data.shape[0]))

    # Training at the shipped quadrotor predictor's width, on the device-resident and in-memory paths.
    def fresh(dropout=0.1, device="cuda"):
        return GainPredictor.create(12, 52, prompt_len=1, target_len=TRAIN_H - 1, d_model=128, nhead=4,
                                    num_decoder_layers=3, dim_feedforward=512, dropout=dropout, max_seq_len=110,
                                    generator=torch.Generator().manual_seed(0), device=device)

    pred = fresh()
    if pred.num_params() != SHIPPED_PARAMS:
        raise AssertionError(f"predictor: {pred.num_params()} parameters, the shipped one has {SHIPPED_PARAMS}")
    train, test = ds.split(0.8, seed=42)
    train_cfg = TrainConfig(batch_size=TRAIN_ROWS_PER_STEP, num_epochs=TRAIN_EPOCHS, lr_schedule="cosine")
    steps = TRAIN_EPOCHS * max(len(train) // TRAIN_ROWS_PER_STEP, 1)
    trained = {}
    for label, data in (("device_resident", (train, test)), ("in_memory", (train.to_host(), test.to_host()))):
        start = time.perf_counter()
        res = train_gain_predictor(pred, *data, train_cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        hist, test_hist = res.train_loss_history, res.test_loss_history
        log(f"training {label} ({pred.num_params()} parameters, {len(train)} rows, batch {TRAIN_ROWS_PER_STEP}, "
            f"{TRAIN_EPOCHS} epochs, cosine): train losses {hist.tolist()}, test {test_hist.tolist()}; "
            f"{seconds:.3f} s, {steps / seconds:.1f} steps/s, {steps * TRAIN_ROWS_PER_STEP / seconds:.1f} rows/s")
        if not (np.isfinite(hist).all() and np.isfinite(test_hist).all() and hist[-1] < hist[0]):
            raise AssertionError(f"training {label}: the loss did not fall: {hist}")
        trained[label] = res.predictor
        results[f"train_{label}"] = dict(seconds=seconds, steps_per_s=steps / seconds,
                                         rows_per_s=steps * TRAIN_ROWS_PER_STEP / seconds, losses=hist.tolist())
    epoch_idle = idle_share(lambda: train_gain_predictor(pred, train, None, train_cfg._replace(num_epochs=1)))
    results["epoch_idle_share"] = epoch_idle

    # The card's Adam steps against the CPU's: the same weights and batches, dropout 0, TF32 off.
    norm = _fit_normalizer_flat(train.x_flat, train.kk_flat, train.x_row_shape, train.kk_row_shape)
    order = torch.randperm(len(train), generator=torch.Generator().manual_seed(1))[:CPU_STEPS * TRAIN_ROWS_PER_STEP]
    losses = {}
    for device in ("cuda", "cpu"):
        module = fresh(dropout=0.0, device=device).module
        module.train()
        optimizer, scheduler = _make_optimizer(module, train_cfg, CPU_STEPS)
        n_dev = norm.to(device)
        step_losses = []
        for ib in order.reshape(CPU_STEPS, TRAIN_ROWS_PER_STEP):
            xb = n_dev.transform_x(train.x_flat[ib.cuda()].reshape((-1,) + train.x_row_shape).to(device))
            kk = n_dev.transform_u(train.kk_flat[ib.cuda()].reshape((-1,) + train.kk_row_shape).to(device))
            step_losses.append(float(_train_step(module, optimizer, scheduler, xb, *_split_tokens(kk, 1))))
        losses[device] = step_losses
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"{CPU_STEPS} Adam steps card against CPU: losses {losses['cuda']} and {losses['cpu']}, max rel "
        f"{step_rel:.3e} (bound {TRAIN_CPU_REL})")
    if not step_rel <= TRAIN_CPU_REL:
        raise AssertionError(f"training steps: card and CPU disagree ({step_rel})")
    results["card_cpu_step_rel"] = step_rel

    # The freshly trained predictor drives the hybrid MPC; held to the pure loop at the same step.
    new_pred = trained["device_resident"]
    ctrl = make_quadrotor_mpc(horizon=50, mode="hybrid", predict_fn=new_pred.predict_fn(),
                              prompt_len=new_pred.prompt_len)
    plant = make_discrete(QuadrotorField(), 0.01, "rk4")
    (x, x_plan, lat, _, _), counts = counted(
        (K1, K2), report,
        lambda: closed_loop(ctrl.step, ctrl.init_state(), plant, quadrotor_start(torch.device("cuda")),
                            TRAINED_HYBRID_STEPS))
    track = float((x - pure_xs[TRAINED_HYBRID_STEPS - 1]).abs().max())
    median_ms, p99_ms = latency(lat)
    log(f"MPC hybrid with the trained predictor: {TRAINED_HYBRID_STEPS} steps, max |x - x(pure)| {track:.3e} (bar "
        f"{HYBRID_TRACK_BAR}), step latency median {median_ms:.2f} ms p99 {p99_ms:.2f} ms, launches {counts}")
    if not (torch.isfinite(x_plan).all() and track < HYBRID_TRACK_BAR):
        raise AssertionError(f"MPC hybrid with the trained predictor left the pure closed loop: {track}")
    results["trained_hybrid"] = dict(track=track, median_ms=median_ms, p99_ms=p99_ms)
    results["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"train phase: max memory allocated {results['max_memory_allocated_bytes']} bytes; idle share of one "
        f"training epoch (profiled) {epoch_idle}, of one control step's collection {step_idle}")
    return results


def random_lq_batch(batch, horizon, dtype, seed=0, n=12, m=4):
    """``random_lq``'s distribution for a batch of trajectories, drawn on the card from a torch seed."""
    from quattro_tpu_torch.solver import CostExpansion

    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen, dtype=dtype, device="cuda")
    eye = lambda d: torch.eye(d, dtype=dtype, device="cuda")
    a = eye(n) + 0.01 * randn(batch, horizon, n, n)
    b = 0.05 * randn(batch, horizon, n, m)
    l_x, l_u = randn(batch, horizon, n), randn(batch, horizon, m)
    w = randn(batch, horizon, n, n)
    l_xx = torch.baddbmm(0.1 * eye(n).expand(batch * horizon, n, n), w.reshape(-1, n, n),
                         w.reshape(-1, n, n).transpose(1, 2), alpha=0.1).reshape(batch, horizon, n, n)
    del w
    exp = CostExpansion(l_x=l_x, l_u=l_u, l_xx=l_xx, l_uu=eye(m).expand(batch, horizon, m, m).contiguous(),
                        l_ux=0.01 * randn(batch, horizon, m, n))
    wf = randn(batch, n, n)
    return a, b, exp, randn(batch, n), wf @ wf.transpose(1, 2) + eye(n)


def lanes_of(stages, lanes):
    from quattro_tpu_torch.solver import CostExpansion

    a, b, exp, v_x, v_xx = stages
    return a[lanes], b[lanes], CostExpansion(*(e[lanes] for e in exp)), v_x[lanes], v_xx[lanes]


def phase_mesh(report):
    """The device-mesh path: the sharded batch solve, the horizon-partitioned and pod-scale passes with the halo
    exchange, the halo check and the data-parallel trainer, on virtual meshes of the one card."""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.ops.fused_riccati import riccati_backward_batched_fused_auto
    from quattro_tpu_torch.parallel import (
        batched_ilqr_solve, collectives, make_mesh, podscale_riccati_backward, sharded_ilqr_solve,
        sharded_riccati_backward,
    )
    from quattro_tpu_torch.parallel.horizon import halo_schedule_spec
    from quattro_tpu_torch.solver import ILQRConfig, riccati_backward_associative, riccati_backward_fused
    from quattro_tpu_torch.training import GainDataset, TrainConfig, train_gain_predictor
    from quattro_tpu_torch.utils import verify_halo_exchange

    results = {}
    start_phase = time.perf_counter()
    default = make_mesh()
    if default.size != torch.cuda.device_count() or any(d.type != "cuda" for d in default.devices.reshape(-1)):
        raise AssertionError(f"make_mesh() is not every visible card: {default}")
    virtual = lambda shape, names=("traj", "horizon"): make_mesh(shape, names, devices=["cuda:0"] * int(np.prod(shape)))
    log(f"mesh: make_mesh() {default.shape} over {[str(d) for d in default.devices.reshape(-1)]}; virtual meshes "
        f"name cuda:0 once per shard")

    # The sharded batch solve, float32: K4 and K7 once per trip of each shard.
    batch = BATCHES[-1]
    problem = suite_batch(torch.float32, batch)
    cfg = ILQRConfig(tol=0.0, max_iter=BATCH_ITERS, linesearch="fused")
    mesh = virtual((MESH_SHARDS, 1))
    sharded, counts = counted((K4, K7), report, lambda: sharded_ilqr_solve(*problem, mesh, cfg))
    expected = MESH_SHARDS * BATCH_ITERS
    plain = batched_ilqr_solve(*problem, cfg)
    same = bool(torch.equal(sharded.iterations, plain.iterations) and torch.equal(sharded.converged, plain.converged))
    cost_rel = float(((sharded.cost - plain.cost).abs() / plain.cost.abs()).max())
    u_abs = float((sharded.u_seq - plain.u_seq).abs().max())
    bitwise = float((sharded.u_seq == plain.u_seq).flatten(1).all(dim=1).float().mean())
    rates = {}
    for label, fn in (("sharded", lambda: sharded_ilqr_solve(*problem, mesh, cfg)),
                      ("unsharded", lambda: batched_ilqr_solve(*problem, cfg))):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates[label] = batch / (time.perf_counter() - start)
    log(f"sharded solve B={batch} float32 on {mesh.shape}: launches {counts} (expected {expected} each); every lane "
        f"against batched_ilqr_solve: iterations/flags equal {same}, max cost rel {cost_rel:.3e} (bound "
        f"{F32_SOLVE_COST_REL}), max |du| {u_abs:.3e} (bound {F32_SOLVE_U_ABS}), lanes bit for bit {bitwise:.4f}; "
        f"solves/s sharded {rates['sharded']:.1f}, unsharded {rates['unsharded']:.1f}")
    if counts != {K4: expected, K7: expected} or not (same and cost_rel <= F32_SOLVE_COST_REL
                                                      and u_abs <= F32_SOLVE_U_ABS):
        raise AssertionError("sharded solve float32: launches or lanes differ from the unsharded solve")
    results["solve_f32"] = dict(launches=counts, cost_rel=cost_rel, u_abs=u_abs, bitwise_share=bitwise,
                                solves_per_s=rates)

    # Float64 on a (4, 1) mesh: the "auto" dispatch takes the "vmap" backend there.
    problem = suite_batch(torch.float64, MESH_F64_BATCH)
    cfg = ILQRConfig(tol=0.0, max_iter=BATCH_ITERS)
    sharded, counts = counted((), report, lambda: sharded_ilqr_solve(*problem, virtual((MESH_F64_SHARDS, 1)), cfg))
    plain = batched_ilqr_solve(*problem, cfg)
    same = bool(torch.equal(sharded.iterations, plain.iterations) and torch.equal(sharded.converged, plain.converged))
    cost_rel = float(((sharded.cost - plain.cost).abs() / plain.cost.abs()).max())
    u_abs = float((sharded.u_seq - plain.u_seq).abs().max())
    log(f"sharded solve B={MESH_F64_BATCH} float64 on ({MESH_F64_SHARDS}, 1): iterations/flags equal {same}, cost "
        f"rel {cost_rel:.3e} (bound {MESH_F64_COST_RTOL}), max |du| {u_abs:.3e} (bound {MESH_F64_U_ATOL})")
    if not (same and cost_rel <= MESH_F64_COST_RTOL and u_abs <= MESH_F64_U_ATOL):
        raise AssertionError("sharded solve float64 differs from the unsharded solve")
    results["solve_f64"] = dict(cost_rel=cost_rel, u_abs=u_abs)

    # The horizon-partitioned pass: one K8 and one K1 launch per shard, the halo hops of the spec.
    mesh = virtual((1, MESH_SHARDS))
    cpu_mesh = make_mesh((1, MESH_SHARDS), devices=["cpu"] * MESH_SHARDS)
    stages = random_lq(MESH_H, torch.float64)
    k1 = riccati_backward_fused(*stages, 1e-6)
    passes = {}
    for mode in ("tree", "ring"):
        collectives.hops.reset()
        out, counts = counted((K8, K1), report, lambda: sharded_riccati_backward(mesh, *stages, scan_mode=mode))
        hops = (collectives.hops.rounds, list(collectives.hops.bytes_per_hop))
        spec = halo_schedule_spec(12, torch.float64, MESH_SHARDS, mode)
        ref = sharded_riccati_backward(cpu_mesh, *to_cpu(stages), scan_mode=mode)
        errs = rel_errs(("k", "K", "V_x", "V_xx"), [o.cpu() for o in out], ref)
        near = (within(out.v_x_seq, k1.v_x_seq, *HORIZON_VX_TOL) and within(out.k_seq, k1.k_seq, *HORIZON_GAIN_TOL)
                and within(out.big_k_seq, k1.big_k_seq, *HORIZON_GAIN_TOL))
        log(f"horizon pass H={MESH_H} float64 {mode} on (1, {MESH_SHARDS}): launches {counts}; hops {hops[0]} of "
            f"{sorted(set(hops[1]))} bytes (spec {spec['rounds']} of {spec['payload_bytes_per_hop']}); card against "
            f"CPU {errs} (bound {MESH_CPU_REL}); within the sequential pass's tolerances of K1: {near} (max |dk| "
            f"{float((out.k_seq - k1.k_seq).abs().max()):.2e})")
        check(f"horizon pass {mode}, card against CPU", errs, MESH_CPU_REL)
        if counts != {K8: MESH_SHARDS, K1: MESH_SHARDS} or not near or hops != (
                spec["rounds"], [spec["payload_bytes_per_hop"]] * spec["rounds"]):
            raise AssertionError(f"horizon pass {mode}: launches {counts}, hops {hops}, near K1 {near}")
        passes[mode] = out
    tree_ring = max(rel_err(t, r) for t, r in zip(passes["tree"], passes["ring"]))
    log(f"horizon pass: tree against ring {tree_ring:.3e} (bound {TREE_RING_REL})")
    if not tree_ring <= TREE_RING_REL:
        raise AssertionError(f"horizon pass: tree and ring disagree ({tree_ring})")
    stages32 = random_lq(MESH_H, torch.float32)
    # One pass each: nothing compiles on the first float32 call (the kernels are built, the rest is eager).
    timing = dict(horizon_tree_ms=time_ms(lambda: sharded_riccati_backward(mesh, *stages32), 1, warm=False),
                  horizon_ring_ms=time_ms(lambda: sharded_riccati_backward(mesh, *stages32, scan_mode="ring"), 1,
                                          warm=False),
                  k1_ms=time_ms(lambda: riccati_backward_fused(*stages32, 1e-6), 20),
                  assoc_ms=time_ms(lambda: riccati_backward_associative(*stages32, 1e-6), 2))
    log(f"horizon pass H={MESH_H} float32 ms per pass: tree {timing['horizon_tree_ms']:.2f}, ring "
        f"{timing['horizon_ring_ms']:.2f}; K1 {timing['k1_ms']:.4f}; associative pass {timing['assoc_ms']:.2f}")
    results["horizon"] = dict(tree_ring_rel=tree_ring, **timing)

    # The pod-scale pass at BASELINE config 5's size: two K8 launches per shard.
    mesh = virtual((2, 4))
    stages = random_lq_batch(POD_BATCH, POD_H, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()  # the pass is timed once, as it runs on the main path (its allocations included)
    pod, counts = counted((K8,), report, lambda: podscale_riccati_backward(mesh, *stages))
    pod_ms = 1e3 * (time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated()
    k4 = riccati_backward_batched_fused_auto(*stages, 1e-6)
    gains_near = within(pod.k_seq, k4[0], *POD_GAIN_TOL) and within(pod.big_k_seq, k4[1], *POD_GAIN_TOL)
    lanes = (0, POD_BATCH // 2, POD_BATCH - 1)
    vx_near = all(within(pod.v_x_seq[i], riccati_backward_fused(*lanes_of(stages, i), 1e-6).v_x_seq, *POD_VX_TOL)
                  for i in lanes)
    gain_err = float((pod.k_seq - k4[0]).abs().max())
    del pod, k4
    k4_ms = time_ms(lambda: riccati_backward_batched_fused_auto(*stages, 1e-6), 3)
    log(f"pod-scale pass B={POD_BATCH} H={POD_H} float32 on (2, 4): launches {counts} (expected {{K8: 16}}); gains "
        f"within rtol {POD_GAIN_TOL[0]}, atol {POD_GAIN_TOL[1]} of K4 on the same stages: {gains_near} (max |dk| "
        f"{gain_err:.2e}); V_x of lanes {lanes} within rtol {POD_VX_TOL[0]}, atol {POD_VX_TOL[1]} of K1: {vx_near}; "
        f"{pod_ms:.1f} ms per pass, K4 {k4_ms:.3f} ms; peak memory {peak} bytes")
    if counts != {K8: 16} or not (gains_near and vx_near):
        raise AssertionError(f"pod-scale pass: launches {counts}, gains near K4 {gains_near}, V_x near K1 {vx_near}")
    del stages
    stages = random_lq_batch(POD_F64_BATCH, POD_F64_H, torch.float64, seed=1)
    out, counts = counted((K8,), report, lambda: podscale_riccati_backward(mesh, *stages))
    ref = podscale_riccati_backward(make_mesh((2, 4), devices=["cpu"] * 8), *to_cpu(stages))
    errs = rel_errs(("k", "K", "V_x", "V_xx"), [o.cpu() for o in out], ref)
    log(f"pod-scale pass B={POD_F64_BATCH} H={POD_F64_H} float64: card against CPU {errs} (bound {MESH_CPU_REL}); "
        f"launches {counts}")
    check("pod-scale pass float64, card against CPU", errs, MESH_CPU_REL)
    results["podscale"] = dict(ms=pod_ms, k4_ms=k4_ms, peak_bytes=peak, gain_abs=gain_err)

    # The halo check on the card.
    mesh = virtual((MESH_SHARDS,), ("horizon",))
    comm = collectives.AxisComm(mesh, "horizon", mesh.coords(("horizon",)))
    a, b = stages[0][0], stages[1][0]
    sent = {c: (a[c[0]], b[c[0]]) for c in comm.local}
    perm = [(i, (i - 1) % MESH_SHARDS) for i in range(MESH_SHARDS)]
    received = comm.ppermute(sent, perm)
    clean = [float(v) for v in verify_halo_exchange(sent, received, comm, perm).values()]
    bad = received[(3,)][0].clone()
    bad.view(torch.int64)[5, 7] ^= 1
    received[(3,)] = (bad, received[(3,)][1])
    flagged = [float(v) for v in verify_halo_exchange(sent, received, comm, perm).values()]
    log(f"halo check: clean {clean}; one bit flipped on shard 3 {flagged}")
    if clean != [0.0] * MESH_SHARDS or flagged != [1.0 if i == 3 else 0.0 for i in range(MESH_SHARDS)]:
        raise AssertionError("halo check: wrong flags")

    # The data-parallel trainer: the shipped predictor's width, mesh= against mesh=None.
    rng = np.random.default_rng(3)
    data = GainDataset(rng.standard_normal((MESH_TRAIN_ROWS, TRAIN_H + 1, 12)).astype(np.float32),
                       rng.standard_normal((MESH_TRAIN_ROWS, TRAIN_H, 52)).astype(np.float32))
    config = TrainConfig(num_epochs=MESH_TRAIN_STEPS, batch_size=MESH_TRAIN_ROWS, lr_schedule="cosine")
    losses, seconds = {}, {}
    for label, train_mesh in (("mesh=None", None), ("mesh", virtual((MESH_TRAIN_SHARDS,), ("data",)))):
        pred = GainPredictor.create(12, 52, prompt_len=1, target_len=TRAIN_H - 1, d_model=128, nhead=4,
                                    num_decoder_layers=3, dim_feedforward=512, dropout=0.0, max_seq_len=110,
                                    generator=torch.Generator().manual_seed(0), device="cuda")
        start = time.perf_counter()
        res, _ = counted((), report, lambda: train_gain_predictor(pred, data, None, config, mesh=train_mesh))
        seconds[label] = time.perf_counter() - start
        losses[label] = res.train_loss_history.tolist()
    step_rel = max(abs(x - y) / abs(y) for x, y in zip(losses["mesh"], losses["mesh=None"]))
    log(f"data-parallel training ({SHIPPED_PARAMS} parameters, {MESH_TRAIN_STEPS} steps of {MESH_TRAIN_ROWS} rows) "
        f"on ({MESH_TRAIN_SHARDS},) against mesh=None: losses {losses['mesh']} and {losses['mesh=None']}, max rel "
        f"{step_rel:.3e} (bound {MESH_TRAIN_REL}); seconds {seconds}")
    if not (len(losses["mesh"]) == MESH_TRAIN_STEPS and step_rel <= MESH_TRAIN_REL):
        raise AssertionError(f"data-parallel training differs from mesh=None ({step_rel})")
    results["train"] = dict(step_rel=step_rel, seconds=seconds)
    results["seconds"] = time.perf_counter() - start_phase
    log(f"mesh phase: {results['seconds']:.1f} s")
    return results


def phase_examples(report, root, pure_xs):
    """The example's collect-and-train path, in process: K4 once per collection trip, then K1 + K2 in the loop."""
    import importlib.util
    import shutil
    import tempfile

    import quattro_tpu_torch
    from quattro_tpu_torch.control import make_quadrotor_mpc
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    start_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "collect_and_train_cuda", os.path.join(root, "examples", "collect_and_train_cuda.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    results = {}
    try:
        for label, argv in EXAMPLE_RUNS:
            argv = [os.path.join(tmp, a) if a.endswith(".npz") else a for a in argv] + ["--device", "cuda"]
            start = time.perf_counter()
            summary, counts = counted((K4,), report, lambda: example.main(argv))
            seconds = time.perf_counter() - start
            trips = summary["trips"]
            steps_s = summary["train_steps"] / summary["train_s"] if "train_s" in summary else None
            log(f"example {label}: rows kept {summary['rows']}, valid {summary['rows_valid']}, dropped "
                f"{summary['rows_dropped']}, {summary['rows'] / summary['collect_s']:.1f} rows/s; K4 launches "
                f"{counts.get(K4, 0)} for {trips} trips, launches {counts}; train steps/s {steps_s}, final losses "
                f"train {summary.get('final_train_loss')} test {summary.get('final_test_loss')}, "
                f"{summary.get('params')} parameters; {seconds:.1f} s")
            if counts != {K4: trips}:
                raise AssertionError(f"example {label}: launches {counts}, expected one K4 per trip ({trips})")
            if summary["rows"] <= 0 or (summary.get("final_train_loss") is not None
                                        and not np.isfinite(summary["final_train_loss"])):
                raise AssertionError(f"example {label}: malformed result {summary}")
            results[label] = dict(summary, seconds=seconds, train_steps_per_s=steps_s,
                                  rows_per_s=summary["rows"] / summary["collect_s"])
        if results["quadrotor_model"]["params"] != SHIPPED_PARAMS:
            raise AssertionError(f"example: {results['quadrotor_model']['params']} parameters, the JAX example's "
                                 f"width has {SHIPPED_PARAMS}")

        # The trained checkpoint, loaded through the package root, drives the hybrid MPC on the card.
        pred = quattro_tpu_torch.GainPredictor.load(os.path.join(tmp, "quad.npz"))
        ctrl = make_quadrotor_mpc(horizon=50, mode="hybrid", predict_fn=pred.predict_fn(),
                                  prompt_len=pred.prompt_len)
        plant = make_discrete(QuadrotorField(), 0.01, "rk4")
        start = time.perf_counter()
        (x, x_plan, lat, _, _), counts = counted(
            (K1, K2), report,
            lambda: closed_loop(ctrl.step, ctrl.init_state(), plant, quadrotor_start(torch.device("cuda")),
                                EXAMPLE_HYBRID_STEPS))
        seconds = time.perf_counter() - start
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    track = float((x - pure_xs[EXAMPLE_HYBRID_STEPS - 1]).abs().max())
    median_ms, p99_ms = latency(lat)
    results["hybrid"] = dict(track=track, median_ms=median_ms, p99_ms=p99_ms, seconds=seconds, launches=counts)
    results["seconds"] = time.perf_counter() - start_phase
    log(f"example checkpoint's hybrid MPC: {EXAMPLE_HYBRID_STEPS} steps, max |x - x(pure)| {track:.3e} (bar "
        f"{HYBRID_TRACK_BAR}), step latency median {median_ms:.2f} ms p99 {p99_ms:.2f} ms, launches {counts}; "
        f"examples phase {results['seconds']:.1f} s")
    if not (torch.isfinite(x_plan).all() and track < HYBRID_TRACK_BAR):
        raise AssertionError(f"MPC hybrid with the example's checkpoint left the pure closed loop: {track}")
    return results


def hybrid_problem(dtype, batch, horizon, near=0, seed=0):
    """The suite's hybrid problem: (dyn, cost, fcost, x0 (B, 12), u0 (B, H, 4), x_ref).

    The bench problem's tables; x0 z = 0.2 + 0.3 U from a numpy seed, x0[6] = 0.1,
    zero controls. The last ``near`` lanes start instead within about 0.02 of
    the reference, at hover thrust.
    """
    dyn, cost, fcost, _, _ = bench_problem(dtype, horizon)
    x_ref = torch.zeros(12, dtype=dtype, device="cuda")
    x_ref[2] = 0.5
    x0 = torch.zeros(batch, 12, dtype=dtype, device="cuda")
    x0[:, 2] = torch.from_numpy(0.2 + 0.3 * np.random.default_rng(seed).random(batch)).to(x0)
    x0[:, 6] = 0.1
    u0 = torch.zeros(batch, horizon, 4, dtype=dtype, device="cuda")
    if near:
        x0[batch - near:] = x_ref + torch.from_numpy(0.02 * np.random.default_rng(seed + 1).standard_normal(
            (near, 12))).to(x0)
        u0[batch - near:] = HOVER_THRUST
    return dyn, cost, fcost, x0, u0, x_ref


def single_hybrid_solves(problem, predict, window, config, state_offset=None, exact_fallback=False):
    """The ``hybrid_ilqr_solve`` of each lane on the card, stacked into a batched ``ILQRSolution``."""
    from quattro_tpu_torch.solver import ILQRSolution, hybrid_ilqr_solve

    dyn, cost, fcost, x0, u0, x_ref = problem
    sols = [hybrid_ilqr_solve(dyn, cost, fcost, predict, window, x, u, x_ref, config, state_offset,
                              exact_fallback=exact_fallback) for x, u in zip(x0, u0)]
    return ILQRSolution(*(torch.stack([torch.as_tensor(getattr(sol, f), device="cuda") for sol in sols])
                          for f in ILQRSolution._fields))


def lanes_against_singles(batched, singles):
    """(iterations and flags equal, max cost rel, max |du|) of a batched solve against its lanes' single solves."""
    same = bool(torch.equal(batched.iterations.long(), singles.iterations.long())
                and torch.equal(batched.converged, singles.converged))
    cost_rel = float(((batched.cost - singles.cost).abs() / singles.cost.abs()).max())
    return same, cost_rel, float((batched.u_seq - singles.u_seq).abs().max())


def initial_rollout(problem):
    """The batched solves' first step: the open-loop rollouts of the warm starts and their costs."""
    from quattro_tpu_torch.parallel import batch

    dyn, cost, fcost, x0, us, _ = problem
    return batch._initial_batch(dyn, cost, fcost, x0, us)


def hybrid_trip_split(problem, predict, window, config):
    """Host wall time (ms, synchronized, median of 3) of each part of one batched trip at the first trip's
    inputs, through the helpers the solves call (quattro_tpu_torch/parallel/batch.py): the hybrid trip's parts,
    and the pure trip's full-horizon derivatives and K4."""
    from quattro_tpu_torch.parallel import batch

    dyn, cost, fcost, x0, us, x_ref = problem
    head = us.shape[1] - window
    offset = torch.zeros_like(x_ref)
    alphas = batch._alphas(config, x0)
    search = batch._batched_line_search(dyn, cost, fcost, config)
    tail_backward = batch._tail_backward(config, x0, us)
    _, full_backward = batch._select_backend(config, x0, us, "auto")
    xs, cs = batch._initial_batch(dyn, cost, fcost, x0, us)
    a, b, exp, fexp = batch._derivatives(dyn, cost, fcost, xs[:, head:], us[:, head:])
    fa, fb, fexp_full, ffin = batch._derivatives(dyn, cost, fcost, xs, us)
    k_tail, big_k_tail = tail_backward(a, b, exp, fexp.v_x, fexp.v_xx)
    k, big_k = batch._hybrid_gains(predict, xs, x_ref, offset, k_tail, big_k_tail)
    found, _, new_x, new_u, new_cost = search(x0, xs, us, k, big_k, cs, alphas)
    active = torch.ones(x0.shape[0], dtype=torch.bool, device="cuda")
    ks, big_ks = torch.zeros_like(k), torch.zeros_like(big_k)

    def select():  # the masked loop's bookkeeping after the line search, the stopping rule included
        kept = batch._keep_active(active, (new_x, new_u, new_cost, k, big_k), (xs, us, cs, ks, big_ks))
        return kept, ~found | ((cs - new_cost).abs() < config.tol)

    parts = {
        "derivatives (window)": lambda: batch._derivatives(dyn, cost, fcost, xs[:, head:], us[:, head:]),
        "K4 (window)": lambda: tail_backward(a, b, exp, fexp.v_x, fexp.v_xx),
        "predictor (with prompt and gains)": lambda: batch._hybrid_gains(predict, xs, x_ref, offset, k_tail,
                                                                         big_k_tail),
        "K7 line search": lambda: search(x0, xs, us, k, big_k, cs, alphas),
        "select": select,
        "pure: derivatives (full)": lambda: batch._derivatives(dyn, cost, fcost, xs, us),
        "pure: K4 (full)": lambda: full_backward(fa, fb, fexp_full, ffin.v_x, ffin.v_xx, config.reg),
    }
    return {name: wall_ms(fn, reps=3) for name, fn in parts.items()}


def float32_single_solves(root, lo, hi):
    """Worker process: the single ``hybrid_ilqr_solve`` of lanes ``lo:hi`` of phase 16's float32 problem at
    H=256 on the card, each field of the stacked solution as a numpy array."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.solver import ILQRConfig

    horizon, name = HYBRID_RUNS[0]
    pred = GainPredictor.load(os.path.join(root, "checkpoints", name), device="cuda")
    dyn, cost, fcost, x0, u0, x_ref = hybrid_problem(torch.float32, HYBRID_BATCH, horizon)
    forced = ILQRConfig(tol=0.0, max_iter=HYBRID_ITERS, linesearch="fused")
    sol = single_hybrid_solves((dyn, cost, fcost, x0[lo:hi], u0[lo:hi], x_ref), pred.predict_fn(), pred.prompt_len,
                               forced)
    return [field.cpu().numpy() for field in sol]


def phase_hybrid(report, root):
    """The batched hybrid solve: the suite's problem at H=256 and 512 beside the pure fused batched solve, and
    lane-for-lane parity with the single hybrid solve on the card."""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve, batched_ilqr_solve
    from quattro_tpu_torch.solver import ILQRConfig, ILQRSolution

    start_phase = time.perf_counter()
    results, hybrids = {}, {}
    forced = ILQRConfig(tol=0.0, max_iter=HYBRID_ITERS, linesearch="fused")
    for horizon, name in HYBRID_RUNS:
        pred = GainPredictor.load(os.path.join(root, "checkpoints", name), device="cuda")
        window, predict = pred.prompt_len, pred.predict_fn()
        problem = hybrid_problem(torch.float32, HYBRID_BATCH, horizon)
        dyn, cost, fcost, x0, u0, x_ref = problem
        solves = {  # bound now: the idle shares call the hybrid solves after this loop
            "pure": functools.partial(batched_ilqr_solve, dyn, cost, fcost, x0, u0, forced),
            "hybrid": functools.partial(batched_hybrid_ilqr_solve, dyn, cost, fcost, predict, window, x0, u0, x_ref,
                                        forced),
        }
        hybrids[horizon] = solves["hybrid"]
        run = dict(window=window, stride=pred.state_stride, params=pred.num_params())
        sols = {}
        for label, solve in solves.items():
            sol, counts = counted((K4, K7), report, solve)
            trips = int(sol.iterations.max())
            log(f"batched {label} H={horizon} B={HYBRID_BATCH}: {trips} trips, launches {counts}, mean cost "
                f"{float(sol.cost.mean()):.6f}, iterations {sorted(set(sol.iterations.tolist()))}")
            if counts != {K4: trips, K7: trips} or (label == "pure" and trips != HYBRID_ITERS):
                raise AssertionError(f"batched {label} H={horizon}: {trips} trips, launches {counts}; expected one K4 "
                                     f"and one K7 launch per trip")
            if not (torch.isfinite(sol.x_seq).all() and sol.x_seq.shape == (HYBRID_BATCH, horizon + 1, 12)
                    and torch.isfinite(sol.cost).all()):
                raise AssertionError(f"batched {label} H={horizon}: malformed solution")
            sols[label] = sol
            run.update({f"{label}_trips": trips, f"{label}_launches": counts,
                        f"{label}_mean_cost": float(sol.cost.mean())})
        # Synchronized calls in turns (pure, hybrid, the initial rollout both start with), before any profiler
        # session of this phase: one slows the host's later launches in its process.
        timed = dict(solves, rollout=functools.partial(initial_rollout, problem))
        times = {label: [] for label in timed}
        for _ in range(HYBRID_TIMED_CALLS):
            for label, fn in timed.items():
                times[label].append(synced_ms(fn))
        run["rollout_ms"] = float(np.median(times["rollout"]))
        for label in solves:
            ms = float(np.median(times[label]))
            trips = run[f"{label}_trips"]
            run.update({f"{label}_ms": ms, f"{label}_ms_per_iter": ms / trips,
                        f"{label}_trip_ms": (ms - run["rollout_ms"]) / trips})
        run["hybrid_vs_pure"] = run["pure_ms_per_iter"] / run["hybrid_ms_per_iter"]
        run["split_ms"] = hybrid_trip_split(problem, predict, window, forced)
        log(f"batched hybrid H={horizon} B={HYBRID_BATCH} (window {window}, stride {pred.state_stride}, "
            f"{pred.num_params()} parameters): ms per iteration for the whole batch, pure {run['pure_ms_per_iter']:.2f} "
            f"(call {run['pure_ms']:.1f}), hybrid {run['hybrid_ms_per_iter']:.2f} (call {run['hybrid_ms']:.1f}), "
            f"pure / hybrid {run['hybrid_vs_pure']:.3f}; the initial rollout {run['rollout_ms']:.1f}; per trip "
            f"without it, pure {run['pure_trip_ms']:.2f}, hybrid {run['hybrid_trip_ms']:.2f}")
        log(json.dumps({"hybrid_trip_split_ms": {"horizon": horizon, **run["split_ms"]}}))
        if horizon == HYBRID_RUNS[0][0]:
            f32_batched = sols["hybrid"]
        results[f"H{horizon}"] = run
    for horizon, hybrid in hybrids.items():
        results[f"H{horizon}"]["idle_share"] = idle = idle_share(hybrid)
        log(f"batched hybrid H={horizon}: device idle share of one call (profiled) {idle}")
    # The float32 lanes' single solves (about 1.5 s each, most of it the eager initial rollout) run in worker
    # processes, beside the float64 parity runs of this process; no timing is taken meanwhile.
    chunks = np.array_split(np.arange(HYBRID_BATCH), F32_SINGLE_WORKERS)
    with ProcessPoolExecutor(F32_SINGLE_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(float32_single_solves, root, int(chunk[0]), int(chunk[-1]) + 1) for chunk in chunks]
        results["parity"] = hybrid_parity(report, root)
        parts = [future.result() for future in futures]
    singles = ILQRSolution(*(torch.from_numpy(np.concatenate(field)).to(f32_batched.cost.device)
                             for field in zip(*parts)))
    same, cost_rel, u_abs = lanes_against_singles(f32_batched, singles)
    horizon = HYBRID_RUNS[0][0]
    log(f"batched hybrid H={horizon} float32, all {len(singles.cost)} lanes against their single solves "
        f"({F32_SINGLE_WORKERS} worker processes): iterations and flags equal {same}, max cost rel {cost_rel:.3e} "
        f"(bound {F32_HYBRID_COST_RTOL}), max |du| {u_abs:.3e}")
    if not cost_rel <= F32_HYBRID_COST_RTOL:
        raise AssertionError(f"float32 batched hybrid lanes disagree with their single solves: {cost_rel}")
    results[f"H{horizon}"].update(f32_lanes_same_iterations=same, f32_lanes_cost_rel=cost_rel, f32_lanes_u_abs=u_abs)
    results["seconds"] = time.perf_counter() - start_phase
    log(f"batched hybrid phase {results['seconds']:.1f} s")
    return results


def hybrid_parity(report, root):
    """Float64 lanes of the batched hybrid solve against their single solves on the card, with and without the
    exact fallback (forced to K4), windows 16 and 1; then the fallback's subsets under "auto" in float32."""
    from quattro_tpu_torch.models import GainPredictor
    from quattro_tpu_torch.parallel import batched_hybrid_ilqr_solve
    from quattro_tpu_torch.solver import ILQRConfig

    config = ILQRConfig(tol=HYBRID_PARITY_TOL, max_iter=HYBRID_PARITY_ITERS, linesearch="fused")
    results = {}
    for horizon, name in HYBRID_PARITY_RUNS:
        pred = GainPredictor.load(os.path.join(root, "checkpoints", name), device="cuda")
        window, predict = pred.prompt_len, pred.predict_fn()
        problem = hybrid_problem(torch.float64, HYBRID_PARITY_BATCH, horizon, near=HYBRID_PARITY_NEAR)
        dyn, cost, fcost, x0, u0, x_ref = problem
        for fallback in (False, True):
            sol, counts = counted((K4, K7), report, lambda: batched_hybrid_ilqr_solve(
                dyn, cost, fcost, predict, window, x0, u0, x_ref, config, x_ref, exact_fallback=fallback,
                riccati_backend="fused"))
            trips = int(sol.iterations.max())
            singles = single_hybrid_solves(problem, predict, window, config, x_ref, fallback)
            same, cost_rel, u_abs = lanes_against_singles(sol, singles)
            label = f"H{horizon}_window{window}_{'fallback' if fallback else 'raw'}"
            log(f"batched hybrid float64 {label}: iterations {sol.iterations.tolist()}, done {sol.converged.tolist()}, "
                f"{trips} trips, launches {counts}; lanes against their single solves: iterations and flags equal "
                f"{same}, max cost rel {cost_rel:.3e} (bound {F64_BATCH_COST_RTOL}), max |du| {u_abs:.3e} (bound "
                f"{F64_BATCH_U_ATOL})")
            # One K4 and one K7 launch per trip, and one more of each per trip whose exact fallback ran.
            extra = counts.get(K4, 0) - trips
            if not (same and cost_rel <= F64_BATCH_COST_RTOL and u_abs <= F64_BATCH_U_ATOL):
                raise AssertionError(f"float64 batched hybrid {label}: lanes disagree with their single solves")
            if counts.get(K7) != counts.get(K4) or not (0 <= extra <= trips) or (extra > 0) != fallback:
                raise AssertionError(f"float64 batched hybrid {label}: launches {counts} for {trips} trips")
            results[label] = dict(iterations=sol.iterations.tolist(), trips=trips, launches=counts,
                                  fallback_trips=extra, cost_rel=cost_rel, u_abs=u_abs)
    # float32 under "auto": the batch of 8 takes the fused backward pass, so subsets of 4 still launch K4.
    pred = GainPredictor.load(os.path.join(root, "checkpoints", HYBRID_PARITY_RUNS[0][1]), device="cuda")
    dyn, cost, fcost, x0, u0, x_ref = hybrid_problem(torch.float32, HYBRID_PARITY_BATCH, HYBRID_PARITY_RUNS[0][0],
                                                     near=HYBRID_PARITY_NEAR)
    sol, counts = counted((K4, K7), report, lambda: batched_hybrid_ilqr_solve(
        dyn, cost, fcost, pred.predict_fn(), pred.prompt_len, x0, u0, x_ref, config, x_ref, exact_fallback=True))
    trips = int(sol.iterations.max())
    log(f"batched hybrid float32 with the fallback under riccati_backend='auto': iterations {sol.iterations.tolist()}, "
        f"{trips} trips, launches {counts}")
    if not (counts.get(K7) == counts.get(K4) and trips < counts.get(K4, 0) <= 2 * trips
            and torch.isfinite(sol.cost).all()):
        raise AssertionError(f"float32 fallback under 'auto': launches {counts} for {trips} trips")
    results["float32_auto_fallback"] = dict(trips=trips, launches=counts)
    return results


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import quattro_tpu_torch
    from quattro_tpu_torch.ops import _build

    package_root = os.path.dirname(os.path.dirname(os.path.abspath(quattro_tpu_torch.__file__)))
    if package_root != root:
        raise RuntimeError(f"quattro_tpu_torch was imported from {package_root}, not from this checkout ({root})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    start = time.perf_counter()
    seconds = _build.build_all(SOURCES)
    log(f"build: {seconds} s each, {time.perf_counter() - start:.1f} s wall")

    report = {}
    k1_times = phase_k1(report)
    k2_times = phase_k2(report)
    k3_times = phase_k3(report)
    phase_k4(report)
    phase_k5(report)
    k67_times = phase_k67(report)
    phase_k9(report)
    phase_k8(report)
    batched = phase_batch(report)
    batched["trip"] = phase_batch_trip(report)
    rates = phase_bench(report)
    mpc, pure_xs = phase_mpc(report, root)
    mega = phase_megakernel(report)
    assoc = phase_assoc(report, pure_xs)
    train = phase_train(report, pure_xs)
    mesh = phase_mesh(report)
    examples = phase_examples(report, root, pure_xs)
    hybrid = phase_hybrid(report, root)
    log(json.dumps({"summary": {"card": smi, "k1_timing": k1_times, "k2_timing": k2_times, "k3_timing": k3_times,
                                "k67_timing": k67_times, "bench_iters_per_s": rates,
                                "mpc": mpc, "mpc_megakernel": mega, "batched": batched, "assoc": assoc,
                                "train": train, "mesh": mesh, "examples": examples, "hybrid": hybrid,
                                "wall_s": time.perf_counter() - _START}}))
    print(smi)
    print(json.dumps({"kernels": [report[name] for name in (K1, K2, K3, K4, K5, K6, K7, K8, K9)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
