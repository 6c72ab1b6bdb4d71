"""GainPredictor: the transformer bound to its weights and normalizer.

Counterpart of ``quattro_tpu/models/gain_predictor.py``. ``load`` reads and
``save`` writes the same self-describing npz checkpoints (hyperparameters
``hp_*``, normalizer statistics, flax-flattened weights ``param/...``); the
weights cross with ``params_from_jax`` and ``params_to_jax``. ``predict_fn`` is the inference closure the
hybrid solves call: normalize the state-error trajectory and the prompt, run
the model, de-normalize the output (float32), for one trajectory or a batch;
``predict`` is its host-side form on numpy arrays.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.models.transformer import TransformerPredictor

_HPARAM_KEYS = (
    "state_dim",
    "control_dim",
    "d_model",
    "nhead",
    "num_decoder_layers",
    "dim_feedforward",
    "dropout",
    "max_seq_len",
    "target_len",
    "prompt_len",
)

_LAYER = re.compile(r"^layer_(\d+)/(.*)$")
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map flax flattened names to a ``TransformerPredictor`` state dict.

    ``layer_i/self_attn/in_proj/kernel`` -> ``layers.i.self_attn.in_proj.weight``
    and so on. A flax ``Dense.kernel`` is (in, out), so it is transposed into
    ``nn.Linear.weight`` (out, in); LayerNorm ``scale`` becomes ``weight``.
    """
    state = {}
    for name, value in flat.items():
        if name == "target_embedding":
            state[name] = torch.from_numpy(np.array(value))
            continue
        path = name
        match = _LAYER.match(name)
        if match:
            path = f"layers/{match.group(1)}/{match.group(2)}"
        *modules, leaf = path.split("/")
        if leaf not in _LEAF:
            raise KeyError(f"unknown parameter {name!r}")
        tensor = torch.from_numpy(np.array(value))
        if leaf == "kernel":
            tensor = tensor.T.contiguous()
        state[".".join(modules + [_LEAF[leaf]])] = tensor
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: a ``TransformerPredictor`` state dict as flax flattened names."""
    flat = {}
    for name, value in state.items():
        array = value.detach().cpu().numpy()
        if name == "target_embedding":
            flat[name] = array
            continue
        *modules, leaf = name.split(".")
        if modules[0] == "layers":
            modules = [f"layer_{modules[1]}"] + modules[2:]
        if leaf == "weight":
            leaf, array = ("kernel", array.T) if array.ndim == 2 else ("scale", array)
        flat["/".join(modules + [leaf])] = np.ascontiguousarray(array)
    return flat


@dataclasses.dataclass
class GainPredictor:
    """Trained gain-sequence predictor on one device.

    ``state_stride`` subsamples the state-error context (token 0, s, 2s, ...)
    before embedding; 1 feeds every state row.
    """

    module: TransformerPredictor
    normalizer: DataNormalizer
    state_stride: int = 1

    def __post_init__(self):
        self.module.eval()
        self._by_dtype: Dict[torch.dtype, TransformerPredictor] = {}

    @staticmethod
    def create(
        state_dim: int,
        control_dim: int,
        prompt_len: int,
        target_len: int,
        d_model: int = 64,
        nhead: int = 8,
        num_decoder_layers: int = 3,
        dim_feedforward: int = 128,
        dropout: float = 0.1,
        max_seq_len: int = 100,
        seq_len_states: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        normalizer: Optional[DataNormalizer] = None,
        state_stride: int = 1,
        device: DeviceLike = None,
    ) -> "GainPredictor":
        """Fresh random-init predictor; the weights come from ``generator`` (seed 0 if absent).

        ``seq_len_states`` is accepted for the JAX signature's sake: there it
        sizes the dummy input that flax initializes from; no parameter shape
        depends on it.
        """
        dev = resolve_device(device)
        module = TransformerPredictor(
            state_dim, control_dim, d_model, nhead, num_decoder_layers, dim_feedforward,
            dropout, max_seq_len, target_len, prompt_len,
        )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        module.reset_parameters(generator)
        if normalizer is None:
            normalizer = DataNormalizer.identity(state_dim, control_dim, device=dev)
        return GainPredictor(module.to(dev), normalizer.to(dev), state_stride)

    @staticmethod
    def from_flat(
        hparams: dict,
        flat: Dict[str, np.ndarray],
        normalizer: DataNormalizer,
        state_stride: int = 1,
        device: DeviceLike = None,
    ) -> "GainPredictor":
        """Build from hyperparameters and flax-flattened weights (see ``params_from_jax``)."""
        dev = resolve_device(device)
        module = TransformerPredictor(**hparams)
        module.load_state_dict(params_from_jax(flat))
        return GainPredictor(module.to(dev), normalizer.to(dev), state_stride)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "GainPredictor":
        """Read a self-describing npz checkpoint written by either package."""
        with np.load(path, allow_pickle=False) as data:
            hparams = {}
            for key in _HPARAM_KEYS:
                raw = data[f"hp_{key}"].item()
                hparams[key] = float(raw) if key == "dropout" else int(raw)
            flat = {key[len("param/") :]: data[key] for key in data.files if key.startswith("param/")}
            normalizer = DataNormalizer(
                *(torch.from_numpy(np.array(data[k])) for k in ("x_mean", "x_std", "u_mean", "u_std"))
            )
            stride = int(data["hp_state_stride"].item()) if "hp_state_stride" in data.files else 1
        return GainPredictor.from_flat(hparams, flat, normalizer, stride, device)

    def save(self, path: str) -> None:
        """Write the self-describing npz checkpoint that ``load`` (of either package) reads."""
        payload = {name: getattr(self.normalizer, name).detach().cpu().numpy()
                   for name in ("x_mean", "x_std", "u_mean", "u_std")}
        for key in _HPARAM_KEYS:
            payload[f"hp_{key}"] = np.asarray(self.module.hparams[key])
        payload["hp_state_stride"] = np.asarray(self.state_stride)
        for key, value in params_to_jax(self.module.state_dict()).items():
            payload[f"param/{key}"] = value
        np.savez(path, **payload)

    @property
    def prompt_len(self) -> int:
        return self.module.prompt_len

    @property
    def target_len(self) -> int:
        return self.module.target_len

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def _module_for(self, dtype: torch.dtype) -> TransformerPredictor:
        # The model computes in the promoted type of its inputs and its
        # float32 weights, as the JAX model does (float64 inputs -> float64).
        if dtype == next(self.module.parameters()).dtype:
            return self.module
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = copy.deepcopy(self.module).to(dtype)
        return self._by_dtype[dtype]

    def predict_fn(
        self, compute_dtype: Optional[torch.dtype] = None
    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Closure ``(x_err_seq (T, n), kK_seq (>=P, c)) -> (target_len, c)`` in float32.

        With a leading batch axis, ``(B, T, n), (B, >=P, c) -> (B, target_len, c)``,
        each row what the unbatched call gives for it. The last ``prompt_len``
        prompt rows are used; dropout is off. The model computes in the
        promoted dtype of its inputs, or in ``compute_dtype`` where given
        (``torch.bfloat16``: the body in bfloat16, normalization and output
        in float32, as JAX's ``compute_dtype=jnp.bfloat16``).
        """
        norm, stride = self.normalizer, self.state_stride

        @torch.no_grad()
        def predict(x_err_seq: torch.Tensor, kk_seq: torch.Tensor) -> torch.Tensor:
            single = x_err_seq.dim() == 2
            if single:
                x_err_seq, kk_seq = x_err_seq[None], kk_seq[None]
            x_norm = norm.transform_x(x_err_seq[:, ::stride])
            prompt = norm.transform_u(kk_seq)[:, -self.prompt_len :]
            dtype = compute_dtype or torch.promote_types(x_norm.dtype, prompt.dtype)
            pred = self._module_for(dtype)(x_norm.to(dtype), prompt.to(dtype))
            pred = norm.inverse_transform_u(pred.to(torch.float32))
            return pred[0] if single else pred

        return predict

    def predict(self, x_seq: np.ndarray, kk_seq: np.ndarray) -> np.ndarray:
        """Host-side ``predict_fn()``: numpy arrays in, a numpy array out."""
        device = self.normalizer.x_mean.device
        out = self.predict_fn()(torch.as_tensor(x_seq, device=device), torch.as_tensor(kk_seq, device=device))
        return out.cpu().numpy()
