"""Per-feature z-score normalization (counterpart of ``quattro_tpu/models/normalizer.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device


class DataNormalizer(NamedTuple):
    x_mean: torch.Tensor  # (state_dim,)
    x_std: torch.Tensor  # (state_dim,)
    u_mean: torch.Tensor  # (control_dim,) -- gain-token features
    u_std: torch.Tensor  # (control_dim,)

    @staticmethod
    def fit(x_data: torch.Tensor, u_data: torch.Tensor, eps: float = 1e-6) -> "DataNormalizer":
        """Fit statistics over axes (0, 1) of (N, T, dim) arrays (population std)."""
        return DataNormalizer(
            x_mean=x_data.mean(dim=(0, 1)),
            x_std=x_data.std(dim=(0, 1), correction=0) + eps,
            u_mean=u_data.mean(dim=(0, 1)),
            u_std=u_data.std(dim=(0, 1), correction=0) + eps,
        )

    @staticmethod
    def identity(
        state_dim: int, control_dim: int, dtype=torch.float32, device: DeviceLike = None
    ) -> "DataNormalizer":
        """No-op normalizer (mean 0, std 1)."""
        dev = resolve_device(device)
        return DataNormalizer(
            x_mean=torch.zeros(state_dim, dtype=dtype, device=dev),
            x_std=torch.ones(state_dim, dtype=dtype, device=dev),
            u_mean=torch.zeros(control_dim, dtype=dtype, device=dev),
            u_std=torch.ones(control_dim, dtype=dtype, device=dev),
        )

    def to(self, device) -> "DataNormalizer":
        return DataNormalizer(*(t.to(device) for t in self))

    def transform_x(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.x_mean) / self.x_std

    def transform_u(self, u: torch.Tensor) -> torch.Tensor:
        return (u - self.u_mean) / self.u_std

    def inverse_transform_u(self, u: torch.Tensor) -> torch.Tensor:
        return u * self.u_std + self.u_mean
