"""iLQR solver stack (counterpart of ``quattro_tpu.solver``)."""

from quattro_tpu_torch.solver.costs import (
    make_quadratic_cost,
    make_quadratic_final_cost,
    softplus_barrier,
)
from quattro_tpu_torch.solver.derivatives import (
    CostExpansion,
    FinalCostExpansion,
    linearize_dynamics,
    quadratize_cost,
    quadratize_final_cost,
)
from quattro_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRLogs,
    ILQRSolution,
    hybrid_ilqr_solve,
    ilqr_solve,
    ilqr_solve_fused,
    ilqr_solve_with_logs,
    pack_gain_tokens,
    unpack_gain_tokens,
)
from quattro_tpu_torch.solver.lqr import lqr_gain, solve_dare
from quattro_tpu_torch.solver.riccati import (
    RiccatiResult,
    riccati_backward,
    riccati_backward_associative,
    riccati_backward_auto,
    riccati_backward_fused,
    riccati_backward_segment,
)
from quattro_tpu_torch.solver.rollout import (
    DEFAULT_ALPHAS,
    feedback_rollout,
    line_search,
    line_search_batched2d,
    line_search_batched_fused,
    line_search_fused,
    simulate,
    trajectory_cost,
)

__all__ = [
    "make_quadratic_cost",
    "make_quadratic_final_cost",
    "softplus_barrier",
    "CostExpansion",
    "FinalCostExpansion",
    "linearize_dynamics",
    "quadratize_cost",
    "quadratize_final_cost",
    "ILQRConfig",
    "ILQRLogs",
    "ILQRSolution",
    "hybrid_ilqr_solve",
    "ilqr_solve",
    "ilqr_solve_fused",
    "ilqr_solve_with_logs",
    "pack_gain_tokens",
    "unpack_gain_tokens",
    "lqr_gain",
    "solve_dare",
    "RiccatiResult",
    "riccati_backward",
    "riccati_backward_segment",
    "riccati_backward_associative",
    "riccati_backward_auto",
    "riccati_backward_fused",
    "DEFAULT_ALPHAS",
    "feedback_rollout",
    "line_search",
    "line_search_batched2d",
    "line_search_batched_fused",
    "line_search_fused",
    "simulate",
    "trajectory_cost",
]
