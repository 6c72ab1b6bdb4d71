"""quattro_tpu_torch: the PyTorch/CUDA port of quattro_tpu.

Transformer-accelerated iLQR for an NVIDIA H100: plain tensor code in
PyTorch, and the hot kernels written by hand in CUDA C++ for ``sm_90a``
(``csrc/``), built at first use (importing the package builds and loads
none). Entry points run on CUDA unless the caller passes ``device="cpu"``.

The root exports the JAX package's public names, the same objects as in
``quattro_tpu_torch.solver`` and ``quattro_tpu_torch.models``.
"""

from quattro_tpu_torch.device import resolve_device
from quattro_tpu_torch.models.gain_predictor import GainPredictor
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.models.torch_port import CARTPOLE_CHECKPOINT, QUADROTOR_CHECKPOINT
from quattro_tpu_torch.models.transformer import TransformerPredictor
from quattro_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRSolution,
    hybrid_ilqr_solve,
    ilqr_solve,
    ilqr_solve_with_logs,
)

__all__ = [
    "ILQRConfig",
    "ILQRSolution",
    "ilqr_solve",
    "ilqr_solve_with_logs",
    "hybrid_ilqr_solve",
    "DataNormalizer",
    "TransformerPredictor",
    "GainPredictor",
    "CARTPOLE_CHECKPOINT",
    "QUADROTOR_CHECKPOINT",
    "resolve_device",
]

__version__ = "0.1.0"
