"""Hand-written CUDA kernels with their plain PyTorch forms.

- ``fused_riccati``: single-trajectory backward Riccati pass (K1).
- ``fused_rollout``: all-alpha closed-loop line-search rollouts (K2).
- ``smallchol``: unrolled small SPD solves (pure forms).

Kernels build lazily on first use (``_build``); ``_build.launches`` counts launches.
"""
