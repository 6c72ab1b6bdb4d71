"""quattro_tpu_torch: the PyTorch/CUDA port of quattro_tpu.

Transformer-accelerated iLQR for an NVIDIA H100: plain tensor code in
PyTorch, and the hot kernels of the single-trajectory solve written by hand
in CUDA C++ for ``sm_90a`` (``csrc/``), built at first use. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from quattro_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
