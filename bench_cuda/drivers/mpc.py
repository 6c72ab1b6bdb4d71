"""Closed-loop MPC: the program's controller against the benchmark's own host plant, in episodes.

Set-up builds the controller from the configuration's factory with the mix's
settings and warms it up on a start of its own. The window then runs episodes
of ``episode_steps`` steps, each from the next of the seed's starts with the
controller's ``init_state()``. A step is timed from handing the plant's state
(float64 on the host) to ``MPCController.step`` until its control is on the
host; the plant (``reference/plants.py``, NumPy float64, RK4) steps outside
that time.

Judged: at most ``judged_firsts`` episodes' first steps (the longest
solves) and steps drawn from the seed among the ``sampled_steps`` of each
episode, at most ``max_judged`` in all.
Each judged step is solved again by the reference from the state handed to
the program and the warm start it carried in: the program's own state,
followed step by step, except at an episode's first step, where the
reference starts from zeros itself. The shift stage is checked apart: the
state handed on holds its last control (``hold_gap``, exact).

The work behind the per-layer metrics is the reference's iterations per
step over the window: the judged first steps' mean and the other judged
steps' mean, each weighted by its share of the window's steps (one first
step per episode started). The judged sample puts first steps first, so its
plain mean would count far more cold starts than the window ran.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_cuda import generate
from bench_cuda.reference import judge
from bench_cuda.reference.plants import HostPlant
from bench_cuda.work.kernels import k2_work, k3_work

EPISODE_POOL = 4096  # starts drawn per seed; a window uses the first ones


def setup(run):
    import quattro_tpu_torch.control as control

    cfg, mix = run.config, run.traffic
    st = SimpleNamespace()
    prog = cfg["program"]
    st.ctrl = getattr(control, prog["factory"])(**prog["factory_args"], **mix["controller"], device=run.device)
    st.plant = HostPlant(cfg)
    st.starts = generate.starts(cfg, generate.rng(run.seed, "starts"), EPISODE_POOL)
    plan = generate.rng(run.seed, "judged")
    steps = mix["episode_steps"]
    st.judged = [{0, *plan.integers(1, steps, size=mix["sampled_steps"]).tolist()} for _ in range(EPISODE_POOL)]
    st.pick = generate.rng(run.seed, "pick")
    # Warm-up: every shape the window uses, on a start of its own.
    x = generate.starts(cfg, generate.rng(run.seed, "warmup"), 1)[0]
    state = st.ctrl.init_state()
    for _ in range(mix["warmup_steps"]):
        u, _, state = st.ctrl.step(torch.from_numpy(x).to(device=run.device, dtype=torch.float32), state)
        x = st.plant.step(x, u.cpu().numpy())
    return st


def window(run, st, seconds: float):
    mix = run.traffic
    steps_per_episode = mix["episode_steps"]
    spans, device = run.spans, run.device
    lat, records = [], []
    failed = 0
    episode, t = -1, steps_per_episode
    x = state = None
    clock = time.perf_counter_ns
    start = clock()
    deadline = start + int(seconds * 1e9)
    while clock() < deadline:
        if t == steps_per_episode or not np.isfinite(x).all():
            a = clock()
            episode, t = episode + 1, 0
            x = st.starts[episode % EPISODE_POOL]
            state = st.ctrl.init_state()
            spans.add("reset", a, clock())
        a = clock()
        x_in = torch.from_numpy(x).to(device=device, dtype=torch.float32)
        u_warm_in = state.u_warm
        u, x_plan, state = st.ctrl.step(x_in, state)
        u_host = u.cpu().numpy()
        b = clock()
        spans.add("mpc_step", a, b)
        lat.append(b - a)
        if t in st.judged[episode % EPISODE_POOL]:
            records.append((episode, t, x_in, u_warm_in, u_host, x_plan, state.u_warm))
        if not np.isfinite(u_host).all():
            failed += 1
        x = st.plant.step(x, u_host)
        spans.add("plant", b, clock())
        t += 1
    end = clock()
    return {"lat_ns": lat, "records": records, "failed": failed, "window_s": 1e-9 * (end - start),
            "start_ns": start, "end_ns": end, "steps": len(lat), "episodes": episode + 1}


def end_to_end(run, st, res):
    lat_ms = 1e-6 * np.asarray(res["lat_ns"], dtype=np.float64)
    return {"mpc_step_ms": float(lat_ms.sum() / len(lat_ms)), "mpc_step_p99_ms": float(np.percentile(lat_ms, 99))}


def counts(run, st, res):
    return len(res["lat_ns"]), res["failed"]


def judge_run(run, st, res, variant: str):
    """The compared numbers with their limits, and the work the judged solves did."""
    cfg, mix = run.config, run.traffic
    records = res["records"]
    firsts = [r for r in records if r[1] == 0]
    others = [r for r in records if r[1] != 0]
    firsts = [firsts[i] for i in st.pick.permutation(len(firsts))[: mix["judged_firsts"]]]
    chosen = (firsts + [others[i] for i in st.pick.permutation(len(others))])[: mix["max_judged"]]
    x0 = torch.stack([r[2].double().cpu() for r in chosen])
    u_warm = torch.stack([torch.zeros_like(r[3]).double().cpu() if r[1] == 0 else r[3].double().cpu() for r in chosen])
    u_answer = torch.stack([torch.cat([torch.from_numpy(r[4]).double()[None], r[6].double().cpu()[:-1]]) for r in chosen])
    x_answer = torch.stack([r[5].double().cpu() for r in chosen])
    hold_gap = max(float((r[6][-1] - r[6][-2]).abs().max()) for r in chosen)
    max_iter, tol = mix["controller"]["max_iter"], cfg["tol"]
    if variant == "control":
        x_answer, u_answer = judge.control_answers(cfg, x0, u_warm, max_iter, tol)
    numbers, iterations = judge.gaps(cfg, x0, u_warm, x_answer, u_answer, max_iter, tol)
    n_first = min(len(firsts), len(chosen))
    steps, first_steps = len(res["lat_ns"]), res["episodes"]
    per_step = iterations_per_step(iterations[:n_first], iterations[n_first:], first_steps, steps)
    h, n, m = cfg["horizon"], cfg["state_dim"], cfg["control_dim"]
    flops = (k2_work(h, n, m, 1, cfg["field_flops"], cfg["dtype"])[1]
             + k3_work(h, n, m, len(cfg["alphas"]), per_step, cfg["field_flops"], cfg["dtype"])[1])
    work = {"judged": len(chosen), "judged_firsts": n_first, "iterations_per_step": per_step,
            "iterations_first": float(np.mean(iterations[:n_first])) if n_first else None,
            "iterations_other": float(np.mean(iterations[n_first:])) if len(chosen) > n_first else None,
            "first_steps": first_steps, "steps": steps, "window_flops": steps * flops,
            "plan_gap": numbers.pop("plan_gap"), "step_median_ms": 1e-6 * float(np.median(res["lat_ns"]))}
    return {**numbers, "hold_gap": hold_gap}, work


def iterations_per_step(first, other, first_steps: int, steps: int) -> float:
    """The window's mean iterations per step: the judged first steps' and the other judged steps' means, each
    weighted by its share of the window's steps; the plain mean where one of the two was not judged."""
    if not len(first) or not len(other):
        return float(np.mean(list(first) + list(other)))
    return (first_steps * float(np.mean(first)) + (steps - first_steps) * float(np.mean(other))) / steps
