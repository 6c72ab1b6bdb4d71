"""Batched solves (counterpart of ``quattro_tpu.parallel``).

``batched_ilqr_solve`` solves a batch of independent trajectories in one call
(``batch.py``); ``batched_ilqr_solve_with_logs`` also logs every iteration.
The device-mesh parts of the JAX package (``mesh``, ``sharded_ilqr_solve``,
horizon partitioning, ``distributed``) are not ported yet: ROADMAP.md,
Queue 1 items 7 and 8.
"""

from quattro_tpu_torch.parallel.batch import batched_ilqr_solve, batched_ilqr_solve_with_logs

__all__ = ["batched_ilqr_solve", "batched_ilqr_solve_with_logs"]
