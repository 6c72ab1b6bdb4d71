"""Host time of one trip of the masked loop (ms/trip), ``parallel/batch.py``: ``batch.trip`` less its ``batch.done_read``.

The host's dispatch of a trip: the stage derivatives' launches (K5 and the
terminal expansion's, or the ``vmap`` derivatives' off the K5 route), K4's
and K7's, the selects, with the wait of the trip's one host read taken out.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    return program_spans.self_ms(program, "batch.trip", "batch.done_read") if program else None
