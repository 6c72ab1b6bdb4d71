"""Batched solves (counterpart of ``quattro_tpu.parallel``).

``batched_ilqr_solve`` solves a batch of independent trajectories in one call
(``batch.py``). The device-mesh parts of the JAX package (``mesh``,
``sharded_ilqr_solve``, horizon partitioning, ``distributed``) are not ported
yet: ROADMAP.md, Queue 1 item 16.
"""

from quattro_tpu_torch.parallel.batch import batched_ilqr_solve

__all__ = ["batched_ilqr_solve"]
