"""Device time of a trip's stage derivatives (ms/trip), ``parallel/batch.py``: span ``batch.derivatives``.

The mean interval between the CUDA events that the ``batch.derivatives``
span records on the stream at its entry and exit: the device time of the
linearization and quadratization of every lane (one K5 launch on the
packed route, ``_linquad_gains``; ``vmap`` derivatives on the natural one,
``_natural_gains``) and of the terminal expansion under ``vmap``, plus any
idle time between them.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    times = [span[5] for span in program.named("batch.derivatives") if span[5] is not None] if program else []
    return sum(times) / len(times) if times else None
