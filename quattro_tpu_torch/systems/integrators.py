"""Explicit integrators lifting continuous dynamics to discrete maps.

Counterpart of ``quattro_tpu/systems/integrators.py``. ``make_discrete``
returns a small callable object instead of a closure: it carries the vector
field, ``dt`` and the integrator, and -- when the field is a plant the CUDA
kernels know (``field.plant``) -- the plant's kind and parameters, which
``ops/fused_rollout.py`` and ``ops/fused_solve.py`` read to pick their
device-side plant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

ContinuousDynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
_METHODS = ("euler", "rk4")


def euler_step(f: ContinuousDynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward Euler: x + dt * f(x, u)."""
    return x + dt * f(x, u)


def rk4_step(f: ContinuousDynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic Runge-Kutta 4 with zero-order-hold control."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@dataclasses.dataclass(frozen=True)
class DiscreteDynamics:
    """Discrete map ``x_next = F(x, u)`` from a vector field, a step and an integrator."""

    field: ContinuousDynamics
    dt: float
    method: str = "rk4"

    @property
    def plant(self) -> Optional[str]:
        """Plant kind a device kernel can evaluate (``None`` for other callables)."""
        return getattr(self.field, "plant", None)

    @property
    def params(self) -> Any:
        return getattr(self.field, "params", None)

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        if self.method == "euler":
            return euler_step(self.field, x, u, self.dt)
        return rk4_step(self.field, x, u, self.dt)


def make_discrete(f: ContinuousDynamics, dt: float, method: str = "rk4") -> DiscreteDynamics:
    """Bind a continuous vector field into a discrete map ``x_next = F(x, u)``."""
    if method not in _METHODS:
        raise ValueError(f"Unknown integration method: {method!r} (want 'euler' or 'rk4')")
    return DiscreteDynamics(f, float(dt), method)
