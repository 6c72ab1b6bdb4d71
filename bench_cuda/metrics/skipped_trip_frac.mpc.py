"""The share of K3's trip budget that its solves left unrun, ``ops/fused_solve.py``.

Σ ``mpc.trips_skipped`` (each solve's ``max_iter`` less the trips K3 ran, as
the launch leaves its loop once the solve is done) over Σ (``mpc.trips`` +
``mpc.trips_skipped``), the trips of ``max_iter`` for every solve. A program
without the ``mpc.trips_skipped`` counter (one whose K3 runs every trip)
reads None.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    if program is None or "mpc.trips_skipped" not in program.counters:
        return None
    skipped, run = program.counters["mpc.trips_skipped"], program.counters.get("mpc.trips", 0)
    if not skipped + run:
        return None
    ctx.note(f"skipped_trip_frac.mpc: {skipped!r} trips skipped, {run!r} run in "
             f"{len(program.named('mpc.step'))} steps")
    return skipped / (skipped + run)
