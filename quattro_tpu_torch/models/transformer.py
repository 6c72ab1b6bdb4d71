"""Decoder-only gain-sequence transformer (counterpart of ``quattro_tpu/models/transformer.py``).

  context = [state-trajectory embeddings | prompt gain-token embeddings]
  input   = context ++ learnable target-token queries
  + sinusoidal positions, causal mask filled with ``finfo.min``,
  N post-LN encoder layers (fused qkv ``in_proj``, ReLU FFN, LayerNorm eps 1e-5),
  linear head on the last ``target_len`` positions.

Submodule names follow the flax module tree so that ``params_from_jax`` maps
one to the other name for name. The matmuls are plain dense products
(``nn.Linear``), as the JAX package leaves them to XLA.

Dropout sits where the JAX model applies ``nn.Dropout``: after the positional
encoding, on the attention output, on the FFN's hidden activation and on its
output. It acts only in training mode (``module.train()``), with flax's law:
keep with probability 1 - p, kept values scaled by 1/(1 - p). The masks come
from the ``rand`` function passed to ``forward``: ``rand(shape, device)``
gives the uniforms of one site (the trainer builds it from its generator,
seeded from its config); without one they come from torch's global
generator. In eval mode dropout returns its input as it is.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn


Rand = Callable[[tuple, torch.device], torch.Tensor]  # rand(shape, device): uniforms on [0, 1)


def _global_rand(shape, device) -> torch.Tensor:
    return torch.rand(shape, device=device)


def _keep_mask(shape, keep_prob: float, rand: Optional[Rand], device) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask of ``shape`` from the uniforms that ``rand`` gives."""
    return (rand or _global_rand)(shape, device) < keep_prob


def dropout(x: torch.Tensor, rate: float, rand: Optional[Rand] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training mode: zero with probability ``rate``, scale the rest by 1/(1 - rate)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = _keep_mask(x.shape, keep_prob, rand, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Standard sin/cos table (max_len, d_model) in float64: even columns sin, odd cos."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term[: d_model // 2])
    return table


class MultiHeadSelfAttention(nn.Module):
    """Causal multi-head self-attention with a fused qkv projection."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        batch, seq_len, _ = x.shape
        head_dim = self.d_model // self.nhead
        q, k, v = self.in_proj(x).split(self.d_model, dim=-1)

        def split_heads(t):
            return t.reshape(batch, seq_len, self.nhead, head_dim).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(head_dim)
        scores = scores.masked_fill(mask, torch.finfo(x.dtype).min)
        context = torch.softmax(scores, dim=-1) @ v
        context = context.transpose(1, 2).reshape(batch, seq_len, self.d_model)
        return self.out_proj(context)


class EncoderLayer(nn.Module):
    """Post-norm block: x = LN(x + Attn(x)); x = LN(x + FFN(x)), dropout in training mode."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadSelfAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, rand: Optional[Rand] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, mask), rate, rand))
        hidden = dropout(torch.relu(self.linear1(x)), rate, rand)
        return self.norm2(x + dropout(self.linear2(hidden), rate, rand))


class TransformerPredictor(nn.Module):
    """Predict ``target_len`` gain tokens from a state trajectory and prompt gains."""

    def __init__(
        self,
        state_dim: int,
        control_dim: int,  # gain-token dim = m * (1 + n)
        d_model: int = 64,
        nhead: int = 8,
        num_decoder_layers: int = 3,
        dim_feedforward: int = 128,
        dropout: float = 0.1,
        max_seq_len: int = 100,
        target_len: int = 20,
        prompt_len: int = 10,
    ):
        super().__init__()
        self.hparams = dict(
            state_dim=state_dim, control_dim=control_dim, d_model=d_model, nhead=nhead,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            dropout=dropout, max_seq_len=max_seq_len, target_len=target_len, prompt_len=prompt_len,
        )
        self.target_len, self.prompt_len = target_len, prompt_len
        self.state_embed = nn.Linear(state_dim, d_model)
        self.control_embed = nn.Linear(control_dim, d_model)
        self.target_embedding = nn.Parameter(torch.empty(target_len, d_model))
        self.layers = nn.ModuleList(
            [EncoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_decoder_layers)]
        )
        self.output_linear = nn.Linear(d_model, control_dim)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positional_encoding(max_len=max_seq_len, d_model=d_model)),
            persistent=False,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init from ``generator``: N(0, 0.02) target tokens, Xavier-uniform weights, zero biases."""
        with torch.no_grad():
            self.target_embedding.normal_(0.0, 0.02, generator=generator)
            for module in self.modules():
                if isinstance(module, nn.Linear):
                    bound = math.sqrt(6.0 / (module.in_features + module.out_features))
                    module.weight.uniform_(-bound, bound, generator=generator)
                    module.bias.zero_()

    def forward(
        self, x_seq: torch.Tensor, u_prompt: torch.Tensor, rand: Optional[Rand] = None
    ) -> torch.Tensor:
        """(B, T, state_dim), (B, prompt_len, control_dim) -> (B, target_len, control_dim).

        ``rand(shape, device)`` gives the dropout uniforms in training mode; eval mode ignores it.
        """
        batch = x_seq.shape[0]
        target = self.target_embedding[None].expand(batch, -1, -1)
        full = torch.cat([self.state_embed(x_seq), self.control_embed(u_prompt), target], dim=1)
        seq_len = full.shape[1]
        full = full + self.positions[None, :seq_len].to(full.dtype)
        full = dropout(full, self.hparams["dropout"] if self.training else 0.0, rand)
        causal = torch.triu(torch.ones(seq_len, seq_len, dtype=torch.bool, device=full.device), diagonal=1)
        for layer in self.layers:
            full = layer(full, causal[None, None], rand)
        return self.output_linear(full[:, -self.target_len :])
