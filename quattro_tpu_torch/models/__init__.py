"""Gain-sequence transformer (counterpart of ``quattro_tpu.models``)."""

from quattro_tpu_torch.models.gain_predictor import GainPredictor, params_from_jax
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.models.transformer import TransformerPredictor

__all__ = ["GainPredictor", "params_from_jax", "DataNormalizer", "TransformerPredictor"]
