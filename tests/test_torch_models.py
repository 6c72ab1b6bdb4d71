"""Port parity: the gain-predictor transformer against quattro_tpu.

The shipped checkpoint (checkpoints/quadrotor_gain.npz, full width: d_model
128, 4 heads, 3 layers, ff 512) is loaded by both packages and run on the
same seeded inputs; de-normalized gains agree to atol 3e-5 when the model
runs in float32 and 1e-9 when it runs in float64 (see F32_ATOL). A
small random model carried across by ``params_from_jax`` is held to rtol
1e-10 in float64.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch.models import DataNormalizer, GainPredictor, TransformerPredictor, params_from_jax

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


def walkthrough_predictors(**create):
    """``tests/test_transformer.py``'s bf16 model (d_model 64, 4 heads, 2 layers, ff 128) in both packages,
    the port's weights carried across by ``params_from_jax`` (float32, as the port keeps them)."""
    hp = dict(state_dim=4, control_dim=5, prompt_len=5, target_len=25, d_model=64, nhead=4, num_decoder_layers=2,
              dim_feedforward=128, max_seq_len=100)
    jpred = JGainPredictor.create(**hp, **create)
    jpred = dataclasses.replace(jpred, params=jax.tree.map(lambda p: p.astype(jnp.float32), jpred.params))
    tpred = GainPredictor.from_flat(dict(hp, dropout=0.1), _flatten_params(jpred.params),
                                    DataNormalizer.identity(4, 5, device="cpu"), device="cpu")
    return jpred, tpred


def test_bf16_predict_close_to_f32_and_to_jax():
    """``predict_fn(compute_dtype=torch.bfloat16)``: float32 outputs within 0.05 of the float32 forward on the
    scale max(|f32|, 1) (``tests/test_transformer.py``'s bar), against the port's and JAX's float32 forward and
    against JAX's bfloat16 forward."""
    jpred, tpred = walkthrough_predictors(seq_len_states=31)
    x = np.random.default_rng(0).normal(size=(31, 4)).astype(np.float32) * np.float32(0.3)
    kk = np.random.default_rng(1).normal(size=(5, 5)).astype(np.float32)
    bf16 = tpred.predict_fn(compute_dtype=torch.bfloat16)(torch.from_numpy(x), torch.from_numpy(kk))
    assert bf16.dtype == torch.float32 and bf16.shape == (25, 5)
    f32 = tpred.predict_fn()(torch.from_numpy(x), torch.from_numpy(kk)).numpy()
    for ref in (f32, np.asarray(jpred.predict_fn()(jnp.asarray(x), jnp.asarray(kk))),
                np.asarray(jpred.predict_fn(compute_dtype=jnp.bfloat16)(jnp.asarray(x), jnp.asarray(kk)))):
        assert np.max(np.abs(bf16.numpy() - ref) / np.maximum(np.abs(ref), 1.0)) < 0.05
    batched = tpred.predict_fn(compute_dtype=torch.bfloat16)(torch.from_numpy(x)[None], torch.from_numpy(kk)[None])
    assert torch.equal(batched[0], bf16)


def test_host_predict_matches_jax():
    """``GainPredictor.predict`` on numpy arrays against JAX's: float32 outputs within two float32 ulps of their
    scale (float64 inputs, so both models run in float64 and round once)."""
    jpred, tpred = walkthrough_predictors()
    rng = np.random.default_rng(2)
    x, kk = 0.3 * rng.standard_normal((31, 4)), rng.standard_normal((7, 5))
    ref = jpred.predict(x, kk)
    out = tpred.predict(x, kk)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32 and out.shape == ref.shape == (25, 5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 * float(np.finfo(np.float32).eps) * np.abs(ref).max())


def test_create_accepts_seq_len_states():
    """``seq_len_states`` sizes JAX's init input only: the same parameter shapes with and without it, and the
    JAX model's count."""
    jpred, _ = walkthrough_predictors(seq_len_states=31)
    args = dict(state_dim=4, control_dim=5, prompt_len=5, target_len=25, d_model=64, nhead=4, num_decoder_layers=2,
                dim_feedforward=128, max_seq_len=100, device="cpu")
    with_len = GainPredictor.create(**args, seq_len_states=31)
    plain = GainPredictor.create(**args)
    assert {k: v.shape for k, v in with_len.module.state_dict().items()} == {
        k: v.shape for k, v in plain.module.state_dict().items()}
    assert with_len.num_params() == jpred.num_params()


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_positional_encoding_dtype_matches_jax(dtype):
    from quattro_tpu.models.transformer import sinusoidal_positional_encoding as j_table
    from quattro_tpu_torch.models import sinusoidal_positional_encoding

    ours = sinusoidal_positional_encoding(40, 17, dtype=getattr(torch, dtype))
    theirs = j_table(40, 17, dtype=getattr(jnp, dtype))
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (40, 17)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs).astype(np.float32))
    assert sinusoidal_positional_encoding(4, 6).dtype == torch.float32  # JAX's default
