"""The whole window's share of the float32 peak (%): the operations its solves needed over window x peak.

The driver counts the operations (``window_flops``) from the frozen work
model at the iterations the window ran: for an MPC step the warm start's
initial rollout and the solve's iterations (``k2_work``, ``k3_work``); for a
batched call every lane's initial rollout and, per lane-iteration, linearize,
quadratize, the backward pass and the all-alpha rollouts (``trip_flops``).
"""

from bench_cuda.work.peaks import FLOPS


def read(ctx):
    flops = ctx.work.get("window_flops")
    return 100.0 * flops / (ctx.trace.window_s * FLOPS[ctx.config["dtype"]]) if flops else None
