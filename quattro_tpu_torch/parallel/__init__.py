"""Parallel runtime: device meshes, sharded batch solves, horizon partitioning.

Counterpart of ``quattro_tpu.parallel``. ``batched_ilqr_solve`` solves a
batch of independent trajectories in one call (``batch.py``);
``batched_ilqr_solve_with_logs`` also logs every iteration. Over a device
mesh (``mesh.py``; collectives in ``collectives.py``):

- ``sharded_ilqr_solve``: the batch cut over the ``traj`` axis;
- ``sharded_riccati_backward`` / ``sharded_suffix_value_functions``: one
  trajectory's horizon cut over the ``horizon`` axis, with the boundary
  value-function halo exchange (``horizon.py``);
- ``podscale_riccati_backward``: both at once over a 2-D mesh
  (``podscale.py``);
- ``distributed``: the multi-process runtime.
"""

from quattro_tpu_torch.parallel import distributed
from quattro_tpu_torch.parallel.batch import batched_ilqr_solve, batched_ilqr_solve_with_logs, sharded_ilqr_solve
from quattro_tpu_torch.parallel.horizon import sharded_riccati_backward, sharded_suffix_value_functions
from quattro_tpu_torch.parallel.mesh import make_mesh, traj_sharding
from quattro_tpu_torch.parallel.podscale import podscale_riccati_backward

__all__ = [
    "make_mesh",
    "traj_sharding",
    "batched_ilqr_solve",
    "batched_ilqr_solve_with_logs",
    "sharded_ilqr_solve",
    "sharded_suffix_value_functions",
    "sharded_riccati_backward",
    "podscale_riccati_backward",
    "distributed",
]
