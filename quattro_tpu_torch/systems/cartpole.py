"""Cart-pole plant as a torch vector field.

Counterpart of ``quattro_tpu/systems/cartpole.py``: state
``x = [pos, vel, theta, theta_dot]`` with ``theta = 0`` upright, control
``u = [force]``; the underactuated pendulum-on-cart equations with the ``4/3``
effective-length factor, and the simplified analytic upright linearization
that the LQR fallback is tuned against. The field broadcasts over leading
batch dimensions and works under ``torch.func`` transforms.

``CartPoleField(params)`` is the same field as a callable that names its
plant, so the CUDA kernels can evaluate it (a bare lambda cannot be).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Tuple

import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device


class CartPoleParams(NamedTuple):
    """Physical parameters (defaults of the reference cart-pole model)."""

    m_cart: float = 1.0
    m_pole: float = 0.1
    length: float = 0.15  # half-length of the pole (pivot to tip)
    gravity: float = 9.81


def cartpole_dynamics(
    x: torch.Tensor, u: torch.Tensor, params: CartPoleParams = CartPoleParams()
) -> torch.Tensor:
    """Continuous-time state derivative dx/dt, shape (..., 4)."""
    # Components are kept as (..., 1) slices, as in the quadrotor field.
    x_dot, theta, theta_dot = x[..., 1:2], x[..., 2:3], x[..., 3:4]
    force = u[..., 0:1]

    m_total = params.m_cart + params.m_pole
    sin_th = torch.sin(theta)
    cos_th = torch.cos(theta)

    # Force + centrifugal term, normalized by total mass.
    temp = (force + params.m_pole * params.length * theta_dot**2 * sin_th) / m_total

    theta_ddot = (-params.gravity * sin_th + cos_th * temp) / (
        params.length * (4.0 / 3.0 - params.m_pole * cos_th**2 / m_total)
    )
    x_ddot = temp - params.m_pole * params.length * theta_ddot * cos_th / m_total

    return torch.cat([x_dot, x_ddot, theta_dot, theta_ddot], dim=-1)


@dataclasses.dataclass(frozen=True)
class CartPoleField:
    """``cartpole_dynamics`` bound to its parameters, tagged with its plant kind."""

    params: CartPoleParams = CartPoleParams()
    plant: ClassVar[str] = "cartpole"

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return cartpole_dynamics(x, u, self.params)


def cartpole_linearized(
    params: CartPoleParams = CartPoleParams(),
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic continuous-time (A, B) at the upright equilibrium.

    The simplified textbook form: it drops the 4/3 pole-inertia factor of the
    nonlinear model, so it does NOT equal the Jacobian of
    ``cartpole_dynamics`` at the origin. It is kept as it is because the LQR
    fallback is tuned against it.
    """
    m_cart, m_pole, length, g = params.m_cart, params.m_pole, params.length, params.gravity
    dev = resolve_device(device)
    a_matrix = torch.tensor(
        [
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, -(m_pole * g) / m_cart, 0.0],
            [0.0, 0.0, 0.0, 1.0],
            [0.0, 0.0, (m_cart + m_pole) * g / (m_cart * length), 0.0],
        ],
        dtype=dtype, device=dev,
    )
    b_matrix = torch.tensor([[0.0], [1.0 / m_cart], [0.0], [-1.0 / (m_cart * length)]], dtype=dtype, device=dev)
    return a_matrix, b_matrix
