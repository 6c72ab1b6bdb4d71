"""Batched solves back to back: ``batched_ilqr_solve`` over a fresh batch of starts per call.

Set-up builds the plant and the costs through the program's own builders from
the configuration's tables, draws every call's starts from the seed (the
configuration's envelope, a Latin hypercube per call), and warms up with one
call on a batch of its own. Each call's warm start is the configuration's
hover control on every step. A call ends with one host read (each lane's
iterations and whether its cost is finite); the window's rate is every lane
solved over the window.

Judged: ``judged_per_call`` lanes of each call drawn from the seed, and each
call's lane with the most iterations (the longest solve), at most
``max_judged``. The reference solves each from its start and the hover warm
start.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_cuda import generate
from bench_cuda.reference import judge
from bench_cuda.work.kernels import k2_work, trip_flops


def setup(run):
    from quattro_tpu_torch import systems
    from quattro_tpu_torch.parallel.batch import batched_ilqr_solve
    from quattro_tpu_torch.solver import ILQRConfig, make_quadratic_cost, make_quadratic_final_cost

    cfg, mix = run.config, run.traffic
    prog, dev = cfg["program"], run.device
    st = SimpleNamespace()
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    field = getattr(systems, prog["field"])(getattr(systems, prog["params"])(**cfg["params"]))
    st.dynamics = systems.make_discrete(field, cfg["dt"], cfg["integration"])
    x_ref = t(cfg["x_ref"])
    st.cost = make_quadratic_cost(t(cfg["q"]), t(cfg["r"]), x_ref, cfg["barrier_alpha"], cfg["barrier_beta"])
    st.final_cost = make_quadratic_final_cost(t(cfg["qf"]), x_ref)
    solver = mix["solver"]
    st.config = ILQRConfig(max_iter=solver["max_iter"], tol=solver["tol"], reg=cfg["reg"], alphas=tuple(cfg["alphas"]),
                           linesearch=solver["linesearch"])
    st.backend = mix["control_backend"] if run.variant == "control" else mix["riccati_backend"]
    st.solve = batched_ilqr_solve
    batch, horizon = mix["batch"], cfg["horizon"]
    st.u_init = t(cfg["hover_control"]).expand(batch, horizon, -1).contiguous()
    gen = generate.rng(run.seed, "starts")
    st.max_calls = int(mix["max_calls_per_second"] * run.seconds) + 2
    st.starts = np.stack([generate.starts(cfg, gen, batch) for _ in range(st.max_calls)]).astype(np.float32)
    pick = generate.rng(run.seed, "judged")
    st.judged = [pick.choice(batch, mix["judged_per_call"], replace=False).tolist() for _ in range(st.max_calls)]
    warm = torch.from_numpy(generate.starts(cfg, generate.rng(run.seed, "warmup"), batch).astype(np.float32)).to(dev)
    _call(st, warm)
    return st


def _call(st, x0):
    sol = st.solve(st.dynamics, st.cost, st.final_cost, x0, st.u_init, st.config, riccati_backend=st.backend)
    flags = torch.stack([sol.iterations.to(torch.float32), torch.isfinite(sol.cost).to(torch.float32)]).cpu()
    return sol, flags


def window(run, st, seconds: float):
    spans, device = run.spans, run.device
    clock = time.perf_counter_ns
    calls, lane_iterations, failed, kept, call_ms = 0, 0, 0, [], []
    start = clock()
    deadline = start + int(seconds * 1e9)
    while clock() < deadline and calls < st.max_calls:
        a = clock()
        x0 = torch.from_numpy(st.starts[calls]).to(device)
        b = clock()
        sol, flags = _call(st, x0)
        c = clock()
        call_ms.append(round(1e-6 * (c - a), 1))
        spans.add("inputs", a, b)
        spans.add("batched_ilqr_solve", b, c)
        iterations = flags[0]
        lanes = st.judged[calls] + [int(torch.argmax(iterations))]
        idx = torch.tensor(lanes, device=device)
        kept.append((calls, lanes, x0[idx], sol.x_seq[idx], sol.u_seq[idx]))
        lane_iterations += int(iterations.sum())
        failed += int((flags[1] == 0).sum())
        calls += 1
        spans.add("keep judged lanes", c, clock())
    if calls >= st.max_calls:
        raise RuntimeError(f"the window ran out of prepared calls ({st.max_calls}): raise max_calls_per_second")
    end = clock()
    return {"calls": calls, "lane_iterations": lane_iterations, "failed": failed, "kept": kept, "call_ms": call_ms,
            "window_s": 1e-9 * (end - start), "start_ns": start, "end_ns": end}


def end_to_end(run, st, res):
    return {"solves_per_s": res["calls"] * run.traffic["batch"] / res["window_s"]}


def counts(run, st, res):
    return res["calls"] * run.traffic["batch"], res["failed"]


def judge_run(run, st, res, variant: str):
    cfg, mix = run.config, run.traffic
    rows = []
    for _, lanes, x0, xs, us in res["kept"]:
        rows.extend(zip(x0.double().cpu(), xs.double().cpu(), us.double().cpu()))
    # Each call's longest lane first, then the seed's draw, up to max_judged.
    per_call = mix["judged_per_call"] + 1
    longest = [rows[i] for i in range(per_call - 1, len(rows), per_call)]
    drawn = [row for i, row in enumerate(rows) if i % per_call != per_call - 1]
    chosen = (longest + drawn)[: mix["max_judged"]]
    x0 = torch.stack([r[0] for r in chosen])
    u_init = torch.tensor(cfg["hover_control"], dtype=torch.float32).double().expand(len(chosen), cfg["horizon"], -1)
    x_answer, u_answer = torch.stack([r[1] for r in chosen]), torch.stack([r[2] for r in chosen])
    solver = mix["solver"]
    numbers, iterations = judge.gaps(cfg, x0, u_init, x_answer, u_answer, solver["max_iter"], solver["tol"])
    h, n, m = cfg["horizon"], cfg["state_dim"], cfg["control_dim"]
    flops = (res["calls"] * mix["batch"] * k2_work(h, n, m, 1, cfg["field_flops"], cfg["dtype"])[1]
             + res["lane_iterations"] * trip_flops(h, n, m, len(cfg["alphas"]), cfg["field_flops"], cfg["dtype"]))
    return numbers, {"judged": len(chosen), "plan_gap": numbers.pop("plan_gap"), "window_flops": flops,
                     "call_ms": res["call_ms"]}
