"""Port parity: the gain-predictor transformer against quattro_tpu.

The shipped checkpoint (checkpoints/quadrotor_gain.npz, full width: d_model
128, 4 heads, 3 layers, ff 512) is loaded by both packages and run on the
same seeded inputs; de-normalized gains agree to atol 3e-5 when the model
runs in float32 and 1e-9 when it runs in float64 (see F32_ATOL). A
small random model carried across by ``params_from_jax`` is held to rtol
1e-10 in float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch.models import GainPredictor, TransformerPredictor, params_from_jax

CHECKPOINT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints", "quadrotor_gain.npz")


def _inputs(rng, states, prompt_len, control_dim, dtype):
    x_err = 0.2 * rng.standard_normal((states, 12))
    kk = rng.standard_normal((prompt_len, control_dim))
    return x_err.astype(dtype), kk.astype(dtype)


def _checkpoint_inputs(norm, rng):
    """Seeded inputs drawn from the checkpoint's own data statistics (its normalizer)."""
    x_err = np.asarray(norm.x_mean) + np.asarray(norm.x_std) * rng.standard_normal((51, 12))
    kk = np.asarray(norm.u_mean) + np.asarray(norm.u_std) * rng.standard_normal((1, 52))
    return x_err.astype(np.float32), kk.astype(np.float32)


# float32: each package's float32 forward is about 2e-5 from the float64
# forward of the same weights on these inputs (de-normalized gains reach
# |25|, where one float32 ulp is 1.9e-6), so the two float32 forwards are
# held to 3e-5 of each other; the float64 forwards to 1e-9.
F32_ATOL = 3e-5
F64_ATOL = 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoint_forward_matches_jax(dtype):
    jpred = JGainPredictor.load(CHECKPOINT)
    tpred = GainPredictor.load(CHECKPOINT, device="cpu")
    assert tpred.num_params() == jpred.num_params() == 616_244
    assert (tpred.prompt_len, tpred.target_len) == (1, 49)
    rng = np.random.default_rng(0)
    for _ in range(2):
        x_err, kk = (v.astype(dtype) for v in _checkpoint_inputs(jpred.normalizer, rng))
        ref = np.asarray(jpred.predict_fn()(jnp.asarray(x_err), jnp.asarray(kk)))
        out = tpred.predict_fn()(torch.from_numpy(x_err), torch.from_numpy(kk))
        assert out.dtype == torch.float32 and out.shape == (49, 52)
        atol = F32_ATOL if dtype == np.float32 else F64_ATOL
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


def test_params_from_jax_maps_every_checkpoint_tensor():
    with np.load(CHECKPOINT) as data:
        flat = {k[len("param/") :]: data[k] for k in data.files if k.startswith("param/")}
    state = params_from_jax(flat)
    module = TransformerPredictor(12, 52, 128, 4, 3, 512, 0.1, 100, 49, 1)
    assert set(state) == set(module.state_dict())
    np.testing.assert_array_equal(
        state["layers.0.self_attn.in_proj.weight"].numpy(), flat["layer_0/self_attn/in_proj/kernel"].T
    )
    np.testing.assert_array_equal(state["layers.2.norm2.weight"].numpy(), flat["layer_2/norm2/scale"])
    with pytest.raises(KeyError):
        params_from_jax({"layer_0/linear1/bogus": flat["layer_0/linear1/bias"]})


@pytest.mark.parametrize("seed", [0, 1])
def test_small_model_forward_matches_jax_float64(seed):
    hp = dict(state_dim=12, control_dim=52, d_model=32, nhead=4, num_decoder_layers=2,
              dim_feedforward=48, dropout=0.0, max_seq_len=40, target_len=10, prompt_len=3)
    jpred = JGainPredictor.create(
        12, 52, 3, 10, d_model=32, nhead=4, num_decoder_layers=2, dim_feedforward=48, dropout=0.0,
        max_seq_len=40, rng=jax.random.PRNGKey(seed),
    )
    module = TransformerPredictor(**hp).double()
    module.load_state_dict(params_from_jax(_flatten_params(jpred.params)))
    module.eval()
    rng = np.random.default_rng(seed)
    x_err, kk = _inputs(rng, 14, 3, 52, np.float64)
    ref = jpred.module.apply({"params": jpred.params}, jnp.asarray(x_err)[None], jnp.asarray(kk)[None], deterministic=True)
    with torch.no_grad():
        out = module(torch.from_numpy(x_err)[None], torch.from_numpy(kk)[None])
    assert out.dtype == torch.float64 and out.shape == (1, 10, 52)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_create_is_seeded_by_its_generator():
    def make(seed):
        return GainPredictor.create(12, 52, 2, 6, d_model=16, nhead=2, num_decoder_layers=1, dim_feedforward=32,
                                    max_seq_len=20, generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = make(3), make(3), make(4)
    for (name, pa), pb, pc in zip(a.module.state_dict().items(), b.module.state_dict().values(),
                                  c.module.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.module.target_embedding, c.module.target_embedding)


def test_load_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GainPredictor.load(CHECKPOINT)
