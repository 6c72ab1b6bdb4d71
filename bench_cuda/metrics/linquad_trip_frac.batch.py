"""The share of the masked loop's trips whose stage derivatives were one K5 launch, ``parallel/batch.py``.

Σ ``batch.linquad_trips`` (the program adds 1 for a trip on the K5 route,
0 for one on the ``vmap`` derivatives) over the ``batch.trip`` spans of the
window. A program without that counter reads None. The note sets
``trips_per_call.batch``'s reading (K4 launches over calls) beside it.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    trips = len(program.named("batch.trip")) if program else 0
    if not trips or "batch.linquad_trips" not in program.counters:
        return None
    linquad = program.counters["batch.linquad_trips"]
    k4, calls = ctx.launches.get("fused_riccati_batched", 0), ctx.work.get("calls", 0)
    ctx.note(f"linquad_trip_frac.batch: {linquad!r} trips on K5 over {trips} trips; trips_per_call.batch "
             f"{k4 / calls if k4 and calls else None!r} ({k4} K4 launches over {calls!r} calls)")
    return linquad / trips
