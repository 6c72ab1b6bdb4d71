"""Plant models as torch vector fields (counterpart of ``quattro_tpu.systems``).

The cart-pole plant is not ported yet (see ROADMAP.md).
"""

from quattro_tpu_torch.systems.integrators import DiscreteDynamics, euler_step, make_discrete, rk4_step
from quattro_tpu_torch.systems.quadrotor import (
    QuadrotorField,
    QuadrotorParams,
    hover_control,
    quadrotor_dynamics,
)

__all__ = [
    "DiscreteDynamics",
    "euler_step",
    "rk4_step",
    "make_discrete",
    "QuadrotorField",
    "QuadrotorParams",
    "quadrotor_dynamics",
    "hover_control",
]
