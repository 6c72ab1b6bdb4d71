"""The wait of the MPC step's one host read (ms/step), ``solver/ilqr.py``: the mean ``mpc.stats_read``.

``ilqr_solve_fused`` reads K3's stats once a solve; the read returns when
K3 and everything launched before it have run, so this is the part of K3's
device time that the host's dispatch did not cover.
"""

from bench_cuda import program_spans


def read(ctx):
    program = program_spans.load(ctx)
    reads = program.named("mpc.stats_read") if program else []
    return 1e-6 * sum(e - s for _, _, s, e, _, _ in reads) / len(reads) if reads else None
