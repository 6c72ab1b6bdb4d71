"""K7's share of its roofline (%), ``ops/fused_rollout.py``: the least time the window's line searches needed over K7's device time.

Work: the all-alpha rollouts of one trajectory (``work/kernels.py:k6_work``,
K7's count) for every iteration of every lane. K7 is ``rollout_group_kernel``
in the trace; in a batched solve no other launch of it runs (K2, its single
form, drives only the single-trajectory paths).
"""

import re

from bench_cuda.work.kernels import bound_ms, k6_work

KERNEL = re.compile(r"rollout_group_kernel")


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    cfg = ctx.config
    need_ms, by = bound_ms(k6_work(ctx.work["lane_iterations"], cfg["horizon"], cfg["state_dim"], cfg["control_dim"],
                                   len(cfg["alphas"]), cfg["field_flops"], cfg["dtype"]), cfg["dtype"])
    ctx.note(f"k7_roofline: bound {need_ms!r} ms ({by}), device {device_s!r} s")
    return 100.0 * 1e-3 * need_ms / device_s
