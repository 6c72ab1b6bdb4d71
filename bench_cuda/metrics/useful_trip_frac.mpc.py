"""The share of K3's trips that the solves needed, ``ops/fused_solve.py``: Σ ``mpc.iterations`` / Σ ``mpc.trips``.

K3 runs its ``max_iter`` trips whatever the data, masked after convergence;
the counters add each solve's iterations (its one host read) and the trips
launched. The note sets the window's iterations per step beside the
driver's estimate from the judged sample.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    if program is None or not program.counters.get("mpc.trips"):
        return None
    iterations, trips = program.counters.get("mpc.iterations", 0), program.counters["mpc.trips"]
    steps = len(program.named("mpc.step"))
    ctx.note(f"useful_trip_frac.mpc: {iterations!r} iterations over {trips!r} K3 trips in {steps} steps "
             f"({iterations / steps if steps else float('nan')!r} iterations per step counted; the judged sample "
             f"estimates {ctx.work.get('iterations_per_step')!r})")
    return iterations / trips
