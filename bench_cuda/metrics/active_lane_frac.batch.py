"""The share of the lanes a trip carries that are still active, ``parallel/batch.py`` masked loop.

Σ ``batch.lanes_active`` (counted from the loop's one host read a trip)
over the trips times the batch. The note sets the count beside the
lane-iterations the solves returned, which it has to equal.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    trips = len(program.named("batch.trip")) if program else 0
    if not trips or "batch.lanes_active" not in program.counters:
        return None
    lanes = program.counters["batch.lanes_active"]
    ctx.note(f"active_lane_frac.batch: {lanes!r} active lanes over {trips} trips of {ctx.traffic['batch']}; "
             f"the solves returned {ctx.work.get('lane_iterations')!r} lane-iterations")
    return lanes / (trips * ctx.traffic["batch"])
