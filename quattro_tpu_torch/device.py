"""Device resolution for the port's entry points.

Every entry point that creates tensors runs on CUDA unless the caller asks for
the CPU. Without a card and without an explicit ``device="cpu"`` it raises; it
never continues quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; a CUDA device without a card raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
