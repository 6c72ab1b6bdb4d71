"""Host time of the program's MPC step (ms/step), ``control/mpc.py``: ``mpc.step`` less its ``mpc.stats_read``.

What the step's Python costs the host, with the wait for K3 taken out: K3's
preparation and launch (on the card K3 also rolls out and costs the warm
start; on CPU tensors the host does, under ``mpc.initial_rollout``), the
warm-start shift. A program span, on the host's clock, over the traced
window.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    return program_spans.self_ms(program, "mpc.step", "mpc.stats_read") if program else None
