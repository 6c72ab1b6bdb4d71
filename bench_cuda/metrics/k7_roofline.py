"""K7's share of its roofline (%), ``ops/fused_rollout.py``: the least time of the window's K7 launches over their device time.

Work: the all-alpha rollouts of one trajectory (``work/kernels.py:k6_work``,
K7's count) for every iteration of every lane, which the trips' launches do,
one a trip beside K4's; and for each launch of the batched rollout beyond
the K4 launches (under ``fused_rollout_batched`` and
``fused_rollout_batched2d`` together), one rollout of the batch at a single
step size, as a warm start's rollout on the device takes. K7 is
``rollout_group_kernel`` in the trace; K2, its single form, drives only the
single-trajectory paths.
"""

import re

from bench_cuda.work.kernels import bound_ms, k6_work

KERNEL = re.compile(r"rollout_group_kernel")
ROLLOUT_LAUNCHES = ("fused_rollout_batched", "fused_rollout_batched2d")
TRIP_LAUNCHES = "fused_riccati_batched"


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    cfg = ctx.config
    shape = (cfg["horizon"], cfg["state_dim"], cfg["control_dim"])
    trips = k6_work(ctx.work["lane_iterations"], *shape, len(cfg["alphas"]), cfg["field_flops"], cfg["dtype"])
    rollouts = sum(ctx.launches.get(name, 0) for name in ROLLOUT_LAUNCHES)
    extra = max(0, rollouts - ctx.launches.get(TRIP_LAUNCHES, 0))
    single = k6_work(ctx.traffic["batch"], *shape, 1, cfg["field_flops"], cfg["dtype"])
    work = (trips[0] + extra * single[0], trips[1] + extra * single[1])
    need_ms, by = bound_ms(work, cfg["dtype"])
    ctx.note(f"k7_roofline: {rollouts} batched rollout launches, {extra} beyond the trips' (one single-step-size "
             f"rollout of the batch each), bound {need_ms!r} ms ({by}), device {device_s!r} s")
    return 100.0 * 1e-3 * need_ms / device_s
