"""Device idle time under the program's unit of work (ms per unit): one MPC step (``mpc.step``) or one batched
call (``batch.solve``).

The device's idle intervals in the window are found as the harness finds
them; an interval counts where its middle lies inside the unit's outermost
program span, and the sum is taken over the number of those spans. The note
splits it by the innermost program span around each middle.

The attribution rests on the tie of the host's clock to the trace. It is
made launch by launch against the kernel launched once per step (K3) or per
trip (K4): no launch may start before the span that launched it began, nor
end after the host read that waits for it returned
(``program_spans.clock_tie``). Where the launches cannot be paired with
their spans so, the metric reads None.
"""

from bench_cuda import program_spans


def read(ctx):
    unit = program_spans.UNITS.get(ctx.traffic.get("driver"))
    program = program_spans.load(ctx) if unit else None
    if program is None or not program.named(unit["outer"]):
        return None
    tie, fault = program_spans.clock_tie(ctx, program, unit)
    if tie is None:
        ctx.note(f"idle_in_program_ms: the clock check failed ({fault}); no reading")
        return None
    program = program_spans.load(ctx, tie.shift)
    outer = program.named(unit["outer"])
    by_inner, outside = {}, 0
    for s, e in program_spans.idle_gaps(ctx.trace):
        inner = program.innermost((s + e) // 2)
        if inner is not None and program.outermost(inner)[1] == unit["outer"]:
            by_inner[inner[1]] = by_inner.get(inner[1], 0) + (e - s)
        else:
            outside += e - s
    per_unit = {name: 1e-6 * ns / len(outer) for name, ns in sorted(by_inner.items(), key=lambda item: -item[1])}
    ctx.note(f"idle_in_program_ms: {len(outer)} {unit['outer']} spans; ms per unit by innermost program span "
             f"{per_unit}; {1e-9 * outside!r} s idle outside them; clock check: {tie.summary()}")
    return sum(per_unit.values())
