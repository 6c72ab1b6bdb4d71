"""K4's share of its roofline (%), ``ops/fused_riccati.py``: the least time the window's backward passes needed over K4's device time.

Work: one backward pass (``work/kernels.py:k4_work``) for every iteration of
every lane (the lane-iterations the solves returned), not for the lanes a
trip carries after they are done. K4 is ``riccati_batched_kernel`` in the trace.
"""

import re

from bench_cuda.work.kernels import bound_ms, k4_work

KERNEL = re.compile(r"riccati_batched_kernel")


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    cfg = ctx.config
    need_ms, by = bound_ms(k4_work(ctx.work["lane_iterations"], cfg["horizon"], cfg["state_dim"], cfg["control_dim"],
                                   cfg["dtype"]), cfg["dtype"])
    ctx.note(f"k4_roofline: {ctx.work['lane_iterations']} lane-iterations, bound {need_ms!r} ms ({by}), "
             f"device {device_s!r} s")
    return 100.0 * 1e-3 * need_ms / device_s
