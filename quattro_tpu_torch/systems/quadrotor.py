"""12-state quadrotor plant as a torch vector field.

Counterpart of ``quattro_tpu/systems/quadrotor.py``: state
``x = [p(3), v(3), (roll, pitch, yaw), (p, q, r)]``, control = four rotor
thrusts (N). The field broadcasts over leading batch dimensions and works
under ``torch.func`` transforms.

``QuadrotorField(params)`` is the same field as a callable that names its
plant, so ``make_discrete(QuadrotorField(params), dt)`` can be rolled out by
the CUDA kernel in ``ops/fused_rollout.py`` (a bare lambda cannot).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device


class QuadrotorParams(NamedTuple):
    """Physical parameters (defaults of the reference quadrotor model)."""

    mass: float = 1.0
    inertia_x: float = 0.02
    inertia_y: float = 0.02
    inertia_z: float = 0.04
    arm: float = 0.1
    gravity: float = 9.81
    k_yaw: float = 0.01


def quadrotor_dynamics(
    x: torch.Tensor, u: torch.Tensor, params: QuadrotorParams = QuadrotorParams()
) -> torch.Tensor:
    """Continuous-time state derivative dx/dt, shape (..., 12)."""
    # Components are kept as (..., 1) slices: under torch.func.jacfwd a 0-dim
    # tensor divided by a Python float comes out in float64.
    vel = x[..., 3:6]
    roll, pitch, yaw = x[..., 6:7], x[..., 7:8], x[..., 8:9]
    p, q, r = x[..., 9:10], x[..., 10:11], x[..., 11:12]

    thrust = u.sum(-1, keepdim=True)

    c_roll, s_roll = torch.cos(roll), torch.sin(roll)
    c_pitch, s_pitch = torch.cos(pitch), torch.sin(pitch)
    c_yaw, s_yaw = torch.cos(yaw), torch.sin(yaw)

    # Inertial-frame acceleration from body-z thrust.
    accel = torch.cat(
        [
            (thrust / params.mass) * (s_yaw * s_roll + c_yaw * s_pitch * c_roll),
            (thrust / params.mass) * (c_yaw * s_roll - s_yaw * s_pitch * c_roll),
            -params.gravity + (thrust / params.mass) * (c_pitch * c_roll),
        ],
        dim=-1,
    )

    # Euler-angle kinematics.
    tan_pitch = torch.tan(pitch)
    euler_rates = torch.cat(
        [
            p + q * s_roll * tan_pitch + r * c_roll * tan_pitch,
            q * c_roll - r * s_roll,
            (q * s_roll + r * c_roll) / c_pitch,
        ],
        dim=-1,
    )

    # X-configuration torque mixing.
    u1, u2, u3, u4 = u[..., 0:1], u[..., 1:2], u[..., 2:3], u[..., 3:4]
    tau_roll = params.arm * ((u2 + u3) - (u1 + u4))
    tau_pitch = params.arm * ((u1 + u2) - (u3 + u4))
    tau_yaw = params.k_yaw * (u1 - u2 + u3 - u4)

    ix, iy, iz = params.inertia_x, params.inertia_y, params.inertia_z
    body_rate_dot = torch.cat(
        [
            ((iy - iz) / ix) * q * r + tau_roll / ix,
            ((iz - ix) / iy) * p * r + tau_pitch / iy,
            ((ix - iy) / iz) * p * q + tau_yaw / iz,
        ],
        dim=-1,
    )

    return torch.cat([vel, accel, euler_rates, body_rate_dot], dim=-1)


@dataclasses.dataclass(frozen=True)
class QuadrotorField:
    """``quadrotor_dynamics`` bound to its parameters, tagged with its plant kind."""

    params: QuadrotorParams = QuadrotorParams()
    plant: ClassVar[str] = "quadrotor"

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return quadrotor_dynamics(x, u, self.params)


def hover_control(
    params: QuadrotorParams = QuadrotorParams(),
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Equilibrium thrust-per-rotor u_eq = m*g/4."""
    return torch.full((4,), params.mass * params.gravity / 4.0, dtype=dtype, device=resolve_device(device))
