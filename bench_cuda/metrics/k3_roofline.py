"""K3's share of its roofline (%), ``ops/fused_solve.py``: the least time the solves needed over K3's device time.

The least time of one solve is the larger of its bytes over the HBM bandwidth
and its operations over the float32 peak (``work/kernels.py:k3_work``), at the
iterations the window's steps needed (K3 runs its fixed trips whatever the
data: the work the inputs need is the iterations'), as the driver estimates
them (``iterations_per_step``: the judged first and other steps, each weighted
by its share of the window's steps). K3 is ``solve_kernel`` in the trace.
"""

import re

from bench_cuda.work.kernels import bound_ms, k3_work

KERNEL = re.compile(r"(?<![A-Za-z_])solve_kernel")


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNEL)
    launches = ctx.launches.get("fused_solve", 0)
    if device_s <= 0 or not launches:
        return None
    cfg = ctx.config
    work = k3_work(cfg["horizon"], cfg["state_dim"], cfg["control_dim"], len(cfg["alphas"]),
                   ctx.work["iterations_per_step"], cfg["field_flops"], cfg["dtype"])
    per_launch_ms, by = bound_ms(work, cfg["dtype"])
    ctx.note(f"k3_roofline: {launches} launches, {ctx.work['iterations_per_step']!r} iterations per step "
             f"({ctx.work['first_steps']} first steps at {ctx.work['iterations_first']!r}, the others at "
             f"{ctx.work['iterations_other']!r}), "
             f"bound {per_launch_ms!r} ms per launch ({by}), device {device_s!r} s")
    return 100.0 * launches * 1e-3 * per_launch_ms / device_s
