"""MPC orchestration (counterpart of ``quattro_tpu.control``)."""

from quattro_tpu_torch.control.switcher import blending_weight
from quattro_tpu_torch.control.mpc import (
    MPCController,
    MPCState,
    build_mpc,
    make_cartpole_mpc,
    make_quadrotor_mpc,
    shift_warm_start,
)

__all__ = [
    "blending_weight",
    "MPCController",
    "MPCState",
    "build_mpc",
    "make_cartpole_mpc",
    "make_quadrotor_mpc",
    "shift_warm_start",
]
