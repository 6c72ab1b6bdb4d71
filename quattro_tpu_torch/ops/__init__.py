"""Hand-written CUDA kernels with their plain PyTorch forms, and the structured linear algebra around them.

- ``fused_riccati``: backward Riccati passes, one trajectory (K1) and a
  batch (K4), with the packed stage layout (``pack_stage``/``unpack_stage``).
- ``fused_rollout``: all-alpha closed-loop line-search rollouts, one
  trajectory (K2) and a batch (K6/K7).
- ``fused_solve``: the whole iLQR solve in one launch (K3).
- ``fused_linquad``: linearize + quadratize of a batch into the packed layout (K5).
- ``smallchol``: unrolled small SPD solves, and the batched Cholesky solve (K8).
- ``smalllu``: unrolled no-pivot LU for the associative Riccati combine.
- ``blocktridiag``: the block-tridiagonal KKT type, its SpMV (K9), assembly,
  block-Thomas solve and residual.

``contract`` states what the kernels take (dtypes, the Riccati step's size
caps, the plants and costs with device code) and holds the wrappers' one
input check and CPU/CUDA dispatch. Kernels build lazily on first use
(``_build``); ``_build.launches`` counts launches. JAX's
``batched_cholesky_solve_pallas`` and ``btd_matvec_pallas`` are
``batched_cholesky_solve_fused`` and ``btd_matvec_fused`` here.
"""

from quattro_tpu_torch.ops.blocktridiag import (
    BlockTridiagonal,
    LQRKKTSystem,
    btd_matvec,
    btd_matvec_fused,
    btd_solve,
    build_lqr_kkt,
    kkt_residual,
    recover_primal,
)
from quattro_tpu_torch.ops.fused_riccati import (
    riccati_backward_batched_fused,
    riccati_backward_batched_fused2d,
    riccati_backward_batched_fused_auto,
    riccati_backward_fused_single,
)
from quattro_tpu_torch.ops.smallchol import (
    batched_cholesky_solve,
    batched_cholesky_solve_fused,
    batched_spd_solve,
)
from quattro_tpu_torch.ops.smalllu import batched_small_solve, lu_solve, unrolled_lu

__all__ = [
    "riccati_backward_batched_fused",
    "riccati_backward_batched_fused2d",
    "riccati_backward_batched_fused_auto",
    "riccati_backward_fused_single",
    "BlockTridiagonal",
    "LQRKKTSystem",
    "btd_matvec",
    "btd_matvec_fused",
    "btd_solve",
    "build_lqr_kkt",
    "kkt_residual",
    "recover_primal",
    "batched_cholesky_solve",
    "batched_cholesky_solve_fused",
    "batched_spd_solve",
    "batched_small_solve",
    "lu_solve",
    "unrolled_lu",
]
