"""Gain-sequence transformer (counterpart of ``quattro_tpu.models``)."""

from quattro_tpu_torch.models.gain_predictor import GainPredictor, params_from_jax, params_to_jax
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.models.torch_port import load_torch_checkpoint
from quattro_tpu_torch.models.transformer import TransformerPredictor, sinusoidal_positional_encoding

__all__ = [
    "GainPredictor",
    "params_from_jax",
    "params_to_jax",
    "DataNormalizer",
    "load_torch_checkpoint",
    "TransformerPredictor",
    "sinusoidal_positional_encoding",
]
