"""Load a PyTorch checkpoint of the reference's gain model into the port's ``GainPredictor``.

Counterpart of ``quattro_tpu/models/torch_port.py``. A checkpoint directory
holds ``tf_model.pt`` (the state dict of a ``torch.nn.TransformerEncoder``
based model, fp16 or fp32) and ``tf_model_normalizer.npz`` (its
hyperparameters and normalizer statistics). The port's layer math is that
of ``torch.nn.TransformerEncoderLayer`` and its weights keep torch's
``(out, in)`` layout, so the tensors load as they are, renamed and cast to
float32: no transposes.

``CARTPOLE_CHECKPOINT`` and ``QUADROTOR_CHECKPOINT`` name the reference
repository's two shipped checkpoint directories, inside a checkout of it whose
root is the environment variable ``QUATTRO_TPU_REFERENCE`` (unset: the paths
are relative, resolved against the working directory).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.models.gain_predictor import GainPredictor
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.models.transformer import TransformerPredictor

# The reference's names of each encoder layer's tensors, by the port's names.
_LAYER_KEYS = {
    "self_attn.in_proj.weight": "self_attn.in_proj_weight",
    "self_attn.in_proj.bias": "self_attn.in_proj_bias",
    "self_attn.out_proj.weight": "self_attn.out_proj.weight",
    "self_attn.out_proj.bias": "self_attn.out_proj.bias",
    "norm1.weight": "norm1.weight",
    "norm1.bias": "norm1.bias",
    "norm2.weight": "norm2.weight",
    "norm2.bias": "norm2.bias",
    "linear1.weight": "linear1.weight",
    "linear1.bias": "linear1.bias",
    "linear2.weight": "linear2.weight",
    "linear2.bias": "linear2.bias",
}
_TOP_KEYS = ("state_embed.weight", "state_embed.bias", "control_embed.weight", "control_embed.bias",
             "output_linear.weight", "output_linear.bias", "target_embedding")


def load_torch_checkpoint(checkpoint_dir: str, device: DeviceLike = None) -> GainPredictor:
    """Build a ``GainPredictor`` from a checkpoint directory (``tf_model.pt`` + ``tf_model_normalizer.npz``)."""
    dev = resolve_device(device)
    meta = np.load(os.path.join(checkpoint_dir, "tf_model_normalizer.npz"), allow_pickle=True)
    module = TransformerPredictor(
        state_dim=int(meta["state_dim"]),
        control_dim=int(meta["control_dim"]),
        d_model=int(meta["d_model"]),
        nhead=int(meta["nhead"]),
        num_decoder_layers=int(meta["num_decoder_layers"]),
        dim_feedforward=int(meta["dim_feedforward"]),
        dropout=float(meta["dropout"]),
        max_seq_len=int(meta["max_seq_len"]),
        target_len=int(meta["target_len"]),
        prompt_len=int(meta["prompt_len"]),
    )
    state = torch.load(os.path.join(checkpoint_dir, "tf_model.pt"), map_location="cpu")
    ported = {key: state[key] for key in _TOP_KEYS}
    for i in range(int(meta["num_decoder_layers"])):
        for ours, theirs in _LAYER_KEYS.items():
            ported[f"layers.{i}.{ours}"] = state[f"transformer_decoder.layers.{i}.{theirs}"]
    module.load_state_dict({key: value.detach().float() for key, value in ported.items()})
    normalizer = DataNormalizer(
        *(torch.from_numpy(np.asarray(meta[k], dtype=np.float32)) for k in ("x_mean", "x_std", "u_mean", "u_std"))
    )
    return GainPredictor(module.to(dev), normalizer.to(dev))


_REFERENCE = os.environ.get("QUATTRO_TPU_REFERENCE", "")
CARTPOLE_CHECKPOINT = os.path.join(
    _REFERENCE, "examples/cartpole/dec3_dmodel128_nhead4_ff256_drop0.1_epoch200_promptlen5_402.7k"
)
QUADROTOR_CHECKPOINT = os.path.join(
    _REFERENCE, "examples/quadrotor/dec3_dmodel128_nhead4_ff512_drop0.1_epoch200_promptlen1_616.2k"
)
