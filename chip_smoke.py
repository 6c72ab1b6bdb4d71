#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (quattro_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Build both CUDA kernels from ``quattro_tpu_torch/csrc`` (one nvcc each, in parallel).
2. K1 (fused Riccati) against its plain PyTorch form on the card, on the
   bench problem's stages (H=100, n=12, m=4), float64 and float32.
3. K2 (fused all-alpha rollouts) against its plain form, quadrotor RK4,
   H=100, A=6, float64 and float32.
4. The bench problem (quadrotor RK4 hover, H=100, 6 forced iterations)
   through K1 + K2, held to the same solve with riccati="seq",
   linesearch="xla"; iterations/s of both.
5. Quadrotor MPC at H=50 (``make_quadrotor_mpc``, whose solves run K1 and
   K2 on the card), pure iLQR and hybrid with the shipped gain
   predictor (checkpoints/quadrotor_gain.npz), closed loop from z=0.2,
   roll=0.15 against the port's RK4 plant; ||x - x_ref|| < 0.05 at the end.
   Before the closed loops, the wall time of each part of one solve
   iteration at H=50 (simulate, derivatives, both Riccati forms, both line
   searches, the predictor) is printed as one ``breakdown_ms`` line; after
   each, the device idle share of its first 3 steps under torch.profiler.

Launch counters are zeroed just before each main-path run (phases 4 and 5)
and read just after it; a kernel of the path that did not launch fails the
run. The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs no network and one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
MPC_ERROR_BAR = 0.05
MPC_STEPS = 300  # closed-loop steps per mode, the span of the error bar
IDLE_STEPS = 3  # MPC steps traced for the device idle share

# Published H100 SXM peaks (NVIDIA data sheet): float32 without tensor
# cores, float64 without tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12

K1 = "fused_riccati_single"
K2 = "fused_rollout_single"
Q = [10.0, 10.0, 50.0, 1.0, 1.0, 1.0, 10.0, 10.0, 50.0, 1.0, 1.0, 1.0]
QF = [100.0, 100.0, 500.0, 10.0, 10.0, 10.0, 100.0, 100.0, 500.0, 10.0, 10.0, 10.0]


_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def time_ms(fn, reps):
    """Per-call device time with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_problem(dtype, horizon=100):
    from quattro_tpu_torch.solver import make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import QuadrotorField, make_discrete

    dev = torch.device("cuda")
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


def bench_stages(dtype):
    """Stage data of the bench problem's first backward pass, and gains from it."""
    from quattro_tpu_torch.solver import (
        linearize_dynamics, quadratize_cost, quadratize_final_cost, riccati_backward, simulate,
    )

    dyn, cost, fcost, x0, u0 = bench_problem(dtype)
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
    nbytes, flops = work
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
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


def phase_k2(report):
    from quattro_tpu_torch.ops.fused_rollout import fused_feedback_rollouts, fused_feedback_rollouts_plain

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
        ms = time_ms(lambda: ilqr_solve(dyn, cost, fcost, x0, u0, cfg), 3)
        rates[label] = 6.0 / (ms / 1e3)
        log(f"bench {label}: {ms:.2f} ms per 6-iteration solve, {rates[label]:.1f} iterations/s")
    return rates


def wall_ms(fn, reps=5):
    """Median host wall time of one synchronized call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return float(np.median(times))


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
    busy_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return None if busy_us <= 0 else 1.0 - busy_us / wall_us


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
    results = {}
    for mode in ("ilqr", "hybrid"):
        kwargs = dict(predict_fn=pred.predict_fn(), prompt_len=pred.prompt_len) if mode == "hybrid" else {}
        ctrl = make_quadrotor_mpc(horizon=50, mode=mode, **kwargs)

        def run(n_steps=MPC_STEPS):
            x = torch.zeros(12, device=dev)
            x[2], x[6] = 0.2, 0.15
            state = ctrl.init_state()
            lat = []
            for _ in range(n_steps):
                t0 = time.perf_counter()
                u, x_plan, state = ctrl.step(x, state)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
                x = plant(x, u)
            return x, x_plan, lat

        (x, x_plan, lat), counts = counted((K1, K2), report, run)
        idle = idle_share(lambda: run(IDLE_STEPS))
        err = float((x - x_ref).norm())
        lat_ms = 1e3 * np.asarray(lat)
        log(f"MPC {mode}: {MPC_STEPS} steps, ||x - x_ref|| = {err:.3e}, step latency median "
            f"{np.median(lat_ms):.2f} ms p99 {np.percentile(lat_ms, 99):.2f} ms, launches {counts}, "
            f"device idle share over the first {IDLE_STEPS} steps (profiled) {idle}")
        if not (torch.isfinite(x_plan).all() and x_plan.shape == (51, 12)):
            raise AssertionError(f"MPC {mode}: malformed plan")
        if not err < MPC_ERROR_BAR:
            raise AssertionError(f"MPC {mode}: ||x - x_ref|| = {err} >= {MPC_ERROR_BAR}")
        results[mode] = dict(err=err, median_ms=float(np.median(lat_ms)), p99_ms=float(np.percentile(lat_ms, 99)),
                             idle_share=idle)
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
    seconds = _build.build_all([K1, K2])
    log(f"build: {seconds} s each, {time.perf_counter() - start:.1f} s wall")

    report = {}
    phase_k1(report)
    phase_k2(report)
    rates = phase_bench(report)
    mpc = phase_mpc(report, root)
    log(json.dumps({"summary": {"card": smi, "bench_iters_per_s": rates, "mpc": mpc}}))
    print(smi)
    print(json.dumps({"kernels": [report[K1], report[K2]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
