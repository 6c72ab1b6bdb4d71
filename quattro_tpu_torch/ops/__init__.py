"""Hand-written CUDA kernels with their plain PyTorch forms.

- ``fused_riccati``: single-trajectory backward Riccati pass (K1).
- ``fused_rollout``: all-alpha closed-loop line-search rollouts (K2).
- ``fused_solve``: the whole iLQR solve in one launch (K3).
- ``smallchol``: unrolled small SPD solves (pure forms).

Kernels build lazily on first use (``_build``); ``_build.launches`` counts launches.
"""
