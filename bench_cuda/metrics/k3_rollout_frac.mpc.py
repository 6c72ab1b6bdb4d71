"""The share of the MPC steps whose warm start K3 rolled out and costed itself, ``ops/fused_solve.py``.

Σ ``mpc.k3_rollouts`` (the program adds 1 for a solve whose initial rollout
and cost ran inside the K3 launch, 0 for one that took K2 and the host's
cost) over the ``mpc.step`` spans of the window. A program without that
counter reads None. The note sets the K2 launches of the run beside it.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    steps = len(program.named("mpc.step")) if program else 0
    if not steps or "mpc.k3_rollouts" not in program.counters:
        return None
    rollouts = program.counters["mpc.k3_rollouts"]
    ctx.note(f"k3_rollout_frac.mpc: {rollouts!r} warm starts rolled out in K3 over {steps} steps; "
             f"{ctx.launches.get('fused_rollout', 0)} K2 launches")
    return rollouts / steps
