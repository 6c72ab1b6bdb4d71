"""Hand-written CUDA kernels with their plain PyTorch forms.

- ``fused_riccati``: backward Riccati passes, one trajectory (K1) and a
  batch (K4), with the packed stage layout (``pack_stage``/``unpack_stage``).
- ``fused_rollout``: all-alpha closed-loop line-search rollouts, one
  trajectory (K2) and a batch (K6/K7).
- ``fused_solve``: the whole iLQR solve in one launch (K3).
- ``fused_linquad``: linearize + quadratize of a batch into the packed layout (K5).
- ``smallchol``: unrolled small SPD solves (pure forms).

Kernels build lazily on first use (``_build``); ``_build.launches`` counts launches.
"""
