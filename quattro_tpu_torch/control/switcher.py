"""Error-norm blending weight between a primary controller and the LQR fallback.

Counterpart of ``quattro_tpu/control/switcher.py``: weight 0 below
``epsilon_low`` (full LQR), 1 above ``epsilon_high`` (full primary), a linear
ramp between. A pure function of the error; no error history is kept.
"""

from __future__ import annotations

import torch


def blending_weight(
    error: torch.Tensor,
    epsilon_low: float = 0.5,
    epsilon_high: float = 1.5,
) -> torch.Tensor:
    """w in [0, 1]: 0 -> full LQR, 1 -> full primary."""
    e_norm = torch.linalg.norm(error)
    ramp = (e_norm - epsilon_low) / (epsilon_high - epsilon_low)
    return torch.clamp(ramp, 0.0, 1.0)
