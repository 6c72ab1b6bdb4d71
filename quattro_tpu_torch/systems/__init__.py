"""Plant models as torch vector fields (counterpart of ``quattro_tpu.systems``)."""

from quattro_tpu_torch.systems.cartpole import (
    CartPoleField,
    CartPoleParams,
    cartpole_dynamics,
    cartpole_linearized,
)
from quattro_tpu_torch.systems.integrators import DiscreteDynamics, euler_step, make_discrete, rk4_step
from quattro_tpu_torch.systems.quadrotor import (
    QuadrotorField,
    QuadrotorParams,
    hover_control,
    quadrotor_dynamics,
)

__all__ = [
    "CartPoleField",
    "CartPoleParams",
    "cartpole_dynamics",
    "cartpole_linearized",
    "DiscreteDynamics",
    "euler_step",
    "rk4_step",
    "make_discrete",
    "QuadrotorField",
    "QuadrotorParams",
    "quadrotor_dynamics",
    "hover_control",
]
