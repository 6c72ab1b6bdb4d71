"""Port parity: ``quattro_tpu_torch.training.train`` and the dropout repair against the JAX trainer.

The JAX trainer's random streams (``jax.random`` permutations and dropout
keys) cannot be reproduced in torch, so parity is held at the level of the
step: the same parameters (carried by ``params_from_jax``, float64), the same
batches in the same order, dropout off, one and several steps of
``jax.value_and_grad`` of the MSE plus ``optax.adam`` driven from the test
against the port's Adam step. Dropout's sites and scale are held by handing
both models the same masks. The rest of ``train_gain_predictor`` is held to
its own semantics (the loss falls, early stopping restores the best
parameters, checkpoint resume, the streamed, in-memory and device-resident
paths agree on the same order), as ``tests/test_training.py`` holds JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models import TransformerPredictor as JTransformer
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch import training
from quattro_tpu_torch.models import GainPredictor, TransformerPredictor, params_from_jax, transformer
from quattro_tpu_torch.training import train as ttrain

HORIZON = 12
PROMPT = 3
# Losses of the same Adam steps, float64: rtol 1e-9 (4.4e-11 measured on the CPU). Parameters: rtol 1e-9 and
# atol 1e-8. Adam moves a parameter by lr * g / (|g| + eps), which turns the rounding noise of a gradient entry
# near zero into a parameter difference of up to lr * noise / eps: 1.8e-9 measured on one entry of the target
# embedding after one step at lr = 3e-3; every other entry within 8e-11.
RTOL = 1e-9
PARAM_ATOL = 1e-8
# The float64 forwards of the two packages: flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch's
# in two passes; 1.6e-9 measured on outputs of order 1 (tests/test_torch_models.py's inputs give 1e-10).
FORWARD_TOL = 1e-8
HP = dict(state_dim=4, control_dim=5, d_model=16, nhead=2, num_decoder_layers=2, dim_feedforward=32,
          max_seq_len=32, target_len=HORIZON - PROMPT, prompt_len=PROMPT)


def jax_model(dropout=0.0, seed=0):
    """A flax model and its parameters in float64."""
    module = JTransformer(**HP, dropout=dropout)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, HORIZON + 1, 4)), jnp.zeros((1, PROMPT, 5)))["params"]
    return module, jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)


def port_model(params, dropout=0.0):
    module = TransformerPredictor(**HP, dropout=dropout)
    module.load_state_dict(params_from_jax(_flatten_params(params)))
    return module.double()


def batches(count, batch=8, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, HORIZON + 1, 4)), rng.standard_normal((batch, PROMPT, 5)),
             rng.standard_normal((batch, HORIZON - PROMPT, 5))) for _ in range(count)]


def assert_params_close(module, params):
    ours = module.state_dict()
    for name, value in params_from_jax(_flatten_params(params)).items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("steps", [1, 6])
def test_adam_steps_match_optax(steps, schedule):
    """k Adam steps on the MSE: the port's step against value_and_grad + optax.adam, float64 (bars above)."""
    jmodule, params = jax_model()
    module = port_model(params).train()
    lr, total = 3e-3, 4  # the cosine schedule reaches its end (and holds 0) within the 6 steps
    config = training.TrainConfig(learning_rate=lr, lr_schedule=schedule, num_epochs=1)
    optimizer, scheduler = ttrain._make_optimizer(module, config, total)
    tx = optax.adam(lr if schedule == "constant" else optax.cosine_decay_schedule(lr, total))
    opt_state = tx.init(params)

    def loss_fn(p, xb, pb, tb):
        pred = jmodule.apply({"params": p}, xb, pb, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean((pred - tb) ** 2)

    for xb, pb, tb in batches(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(xb), jnp.asarray(pb), jnp.asarray(tb))
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        ours = ttrain._train_step(module, optimizer, scheduler, *(torch.from_numpy(a) for a in (xb, pb, tb)))
        np.testing.assert_allclose(float(ours), float(loss), rtol=RTOL)
    assert_params_close(module, params)


def test_cosine_learning_rate_equals_optax_at_every_step():
    lr, steps_per_epoch, epochs = 1e-3, 7, 3
    module = torch.nn.Linear(2, 1)
    config = training.TrainConfig(learning_rate=lr, lr_schedule="cosine", num_epochs=epochs)
    optimizer, scheduler = ttrain._make_optimizer(module, config, steps_per_epoch)
    schedule = optax.cosine_decay_schedule(lr, steps_per_epoch * epochs)
    for count in range(steps_per_epoch * epochs + 3):  # past the end the rate stays 0
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], float(schedule(count)), rtol=1e-12, atol=1e-18)
        optimizer.step()
        scheduler.step()
    optimizer, scheduler = ttrain._make_optimizer(module, config._replace(lr_schedule="constant"), 5)
    assert scheduler is None and optimizer.param_groups[0]["lr"] == lr
    defaults = optimizer.defaults
    assert defaults["betas"] == (0.9, 0.999) and defaults["eps"] == 1e-8
    with pytest.raises(ValueError, match="lr_schedule"):
        ttrain._make_optimizer(module, config._replace(lr_schedule="linear"), 5)


class MaskQueue:
    """Hands the same keep masks to both packages' dropout, in call order."""

    def __init__(self, seed, rate):
        self.rng, self.rate, self.masks, self.served = np.random.default_rng(seed), rate, [], 0

    def draw(self, shape):
        if self.served == len(self.masks):
            self.masks.append(self.rng.random(tuple(shape)) >= self.rate)
        mask = self.masks[self.served]
        assert mask.shape == tuple(shape)
        self.served += 1
        return mask


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_sites_and_scale_match_flax(monkeypatch, rate):
    """Given the same masks, the port's training-mode forward equals flax's: the four sites (after the positional
    encoding; per layer the attention output, the FFN hidden activation and the FFN output), in flax's order, and
    the 1/(1-p) scale."""
    jmodule, params = jax_model(dropout=rate)
    module = port_model(params, dropout=rate).train()
    x, p, _ = batches(1, batch=3)[0]
    jqueue, tqueue = MaskQueue(5, rate), MaskQueue(5, rate)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(jqueue.draw(shape)))
    monkeypatch.setattr(transformer, "_keep_mask",
                        lambda shape, keep, rand, device: torch.from_numpy(tqueue.draw(shape)))
    ref = jmodule.apply({"params": params}, jnp.asarray(x), jnp.asarray(p), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    out = module(torch.from_numpy(x), torch.from_numpy(p))
    assert jqueue.served == tqueue.served == 1 + 3 * HP["num_decoder_layers"]
    assert [m.shape for m in jqueue.masks] == [m.shape for m in tqueue.masks]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=FORWARD_TOL, atol=FORWARD_TOL)
    eval_out = module.eval()(torch.from_numpy(x), torch.from_numpy(p))
    assert tqueue.served == 1 + 3 * HP["num_decoder_layers"]  # eval draws no mask
    assert not np.allclose(eval_out.detach().numpy(), out.detach().numpy())


def test_dropout_law_and_eval_unchanged():
    """dropout(): kept values scaled by 1/(1-p), the rest zero, masks from the caller's seeded uniforms; p=0 and
    eval mode are the identity, so the eval forward of a p=0.1 model is bit for bit the p=0 model's."""
    x = torch.randn(2000, generator=torch.Generator().manual_seed(0), dtype=torch.float64)

    def seeded(seed):
        gen = torch.Generator().manual_seed(seed)
        return lambda shape, device: torch.rand(shape, generator=gen, device=device)

    out = transformer.dropout(x, 0.25, seeded(3))
    again = transformer.dropout(x, 0.25, seeded(3))
    assert torch.equal(out, again)
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.2 < 1 - float(kept.double().mean()) < 0.3
    assert transformer.dropout(x, 0.0) is x and not transformer.dropout(x, 1.0).any()

    _, params = jax_model()
    with_dropout, without = port_model(params, dropout=0.1), port_model(params, dropout=0.0)
    x, p, _ = (torch.from_numpy(a) for a in batches(1)[0])
    assert torch.equal(with_dropout.eval()(x, p), without.eval()(x, p))
    assert torch.equal(without.train()(x, p), without.eval()(x, p))


@pytest.fixture(scope="module")
def dataset():
    """tests/test_training.py's fixture, collected by the port (float64)."""
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    rng = np.random.default_rng(0)
    x0 = np.zeros((6, 4))
    x0[:, 0], x0[:, 2] = 0.3 * rng.standard_normal(6), 0.3 * rng.standard_normal(6)
    return training.collect_gain_dataset(
        tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
        tsolver.make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4)),
        tsolver.make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t([0.0] * 4)),
        torch.from_numpy(x0), HORIZON, 1, 10, tsolver.ILQRConfig(tol=1e-1, max_iter=8))


def small_predictor(state_stride=1, dropout=0.1, d_model=32):
    return GainPredictor.create(4, 5, PROMPT, HORIZON - PROMPT, d_model=d_model, nhead=4, num_decoder_layers=1,
                                dim_feedforward=64, dropout=dropout, max_seq_len=64, state_stride=state_stride,
                                generator=torch.Generator().manual_seed(0), device="cpu")


def split(ds, frac=0.8):
    cut = int(ds.x_data.shape[0] * frac)
    return (training.GainDataset(ds.x_data[:cut], ds.kk_data[:cut]),
            training.GainDataset(ds.x_data[cut:], ds.kk_data[cut:]))


def test_training_reduces_the_loss_and_leaves_the_input_predictor(dataset):
    train, test = split(dataset)
    predictor = small_predictor()
    before = {k: v.clone() for k, v in predictor.module.state_dict().items()}
    result = training.train_gain_predictor(predictor, train, test,
                                           training.TrainConfig(num_epochs=12, batch_size=16))
    assert result.train_loss_history[-1] < result.train_loss_history[0] * 0.8, result.train_loss_history
    assert len(result.test_loss_history) == 12
    assert all(torch.equal(v, predictor.module.state_dict()[k]) for k, v in before.items())
    assert not result.predictor.module.training
    out = result.predictor.predict_fn()(torch.from_numpy(train.x_data[0]).float(),
                                        torch.from_numpy(train.kk_data[0]).float())
    assert out.shape == (HORIZON - PROMPT, 5) and torch.isfinite(out).all()


def _test_loss(predictor, data):
    x, p, t = ttrain._prepare(data, predictor.normalizer, predictor.prompt_len, predictor.state_stride)
    with torch.no_grad():
        return float(torch.mean((predictor.module(x, p) - t) ** 2))


def test_early_stopping_restores_the_best_parameters(dataset):
    """A learning rate far too large makes the test loss rise: training stops after ``patience`` epochs without
    improvement, and the returned parameters are those of the best test loss."""
    train, test = split(dataset)
    result = training.train_gain_predictor(
        small_predictor(), train, test,
        training.TrainConfig(num_epochs=30, batch_size=16, learning_rate=0.05, patience=2))
    hist = result.test_loss_history
    assert len(hist) < 30 and int(np.argmin(hist)) == len(hist) - 3
    np.testing.assert_allclose(_test_loss(result.predictor, test), hist.min(), rtol=1e-5)


def test_checkpoint_resume(dataset, tmp_path):
    """tests/test_training.py's resume case: 4 epochs saving every 2, then a run to 8 from the same directory
    resumes at epoch 4 and runs only the remaining 4; the 3 latest checkpoints are kept."""
    ckpt = str(tmp_path / "ckpts")
    data = training.GainDataset(dataset.x_data, dataset.kk_data)
    predictor = small_predictor(d_model=16)
    r1 = training.train_gain_predictor(predictor, data, None, training.TrainConfig(
        num_epochs=4, batch_size=16, checkpoint_dir=ckpt, checkpoint_every=2, lr_schedule="cosine"))
    assert sorted(int(d) for d in __import__("os").listdir(ckpt)) == [2, 4]
    r2 = training.train_gain_predictor(predictor, data, None, training.TrainConfig(
        num_epochs=8, batch_size=16, checkpoint_dir=ckpt, checkpoint_every=2, lr_schedule="cosine"))
    assert len(r2.train_loss_history) == 4, "resume should only run the remaining epochs"
    assert r2.train_loss_history[-1] < r1.train_loss_history[0]
    assert sorted(int(d) for d in __import__("os").listdir(ckpt)) == [4, 6, 8]
    saved = torch.load(str(tmp_path / "ckpts" / "4" / "state.pt"))
    assert saved["epoch"] == 4 and saved["scheduler"]["last_epoch"] == 4 * (data.x_data.shape[0] // 16)
    r3 = training.train_gain_predictor(predictor, data, None, training.TrainConfig(
        num_epochs=8, batch_size=16, checkpoint_dir=ckpt, checkpoint_every=2, lr_schedule="cosine"))
    assert len(r3.train_loss_history) == 0  # nothing left to run
    for name, value in r2.predictor.module.state_dict().items():
        torch.testing.assert_close(r3.predictor.module.state_dict()[name], value, rtol=0, atol=0)


def test_streamed_training_equals_in_memory_on_the_same_order(dataset, tmp_path):
    """ShardDataset minibatches (gathered per step from the shard) against the in-memory rows: the same
    permutation gives the same losses (the normalizer statistics differ only in rounding)."""
    train, test = split(dataset)
    tpath = training.save_gain_dataset(str(tmp_path / "train.qtshard"), train, rows_per_record=7)
    epath = training.save_gain_dataset(str(tmp_path / "test.qtshard"), test, rows_per_record=5)
    config = training.TrainConfig(num_epochs=3, batch_size=8)
    memory = training.train_gain_predictor(small_predictor(), train, test, config)
    streamed_train, streamed_test = training.ShardDataset(tpath), training.ShardDataset(epath)
    try:
        streamed = training.train_gain_predictor(small_predictor(), streamed_train, streamed_test, config)
    finally:
        streamed_train.close()
        streamed_test.close()
    np.testing.assert_allclose(streamed.train_loss_history, memory.train_loss_history, rtol=1e-5)
    np.testing.assert_allclose(streamed.test_loss_history, memory.test_loss_history, rtol=1e-5)


def test_device_resident_training_equals_in_memory(dataset):
    """The device-resident path on the same permutation takes the same batches as the in-memory path."""
    train, test = split(dataset)
    config = training.TrainConfig(num_epochs=4, batch_size=16, lr_schedule="cosine")
    memory = training.train_gain_predictor(small_predictor(), train, test, config)
    resident = training.train_gain_predictor(small_predictor(), training.DeviceGainDataset.from_host(train, "cpu"),
                                             training.DeviceGainDataset.from_host(test, "cpu"), config)
    np.testing.assert_allclose(resident.train_loss_history, memory.train_loss_history, rtol=1e-5)
    np.testing.assert_allclose(resident.test_loss_history, memory.test_loss_history, rtol=1e-5)
    tiny = training.DeviceGainDataset.from_host(training.GainDataset(train.x_data[:5], train.kk_data[:5]), "cpu")
    few = training.train_gain_predictor(small_predictor(), tiny, None, config._replace(num_epochs=2))
    assert few.train_loss_history.shape == (2,) and np.isfinite(few.train_loss_history).all()


def test_state_stride_roundtrip_and_training(dataset, tmp_path):
    """state_stride: training consumes strided contexts, predict strides at inference, and the stride survives
    the checkpoint, which the JAX package loads to the same predictions."""
    result = training.train_gain_predictor(small_predictor(state_stride=3), dataset, None,
                                           training.TrainConfig(num_epochs=2, batch_size=8))
    x, kk = np.zeros((HORIZON + 1, 4), np.float32), np.zeros((HORIZON, 5), np.float32)
    out = result.predictor.predict_fn()(torch.from_numpy(x), torch.from_numpy(kk))
    assert out.shape == (HORIZON - PROMPT, 5)
    path = str(tmp_path / "strided.npz")
    result.predictor.save(path)
    loaded = GainPredictor.load(path, device="cpu")
    assert loaded.state_stride == 3
    torch.testing.assert_close(loaded.predict_fn()(torch.from_numpy(x), torch.from_numpy(kk)), out, rtol=0, atol=0)
    jloaded = JGainPredictor.load(path)
    assert jloaded.state_stride == 3
    np.testing.assert_allclose(jloaded.predict(x, kk), out.numpy(), rtol=1e-5, atol=1e-6)


def test_mesh_is_refused(dataset):
    """JAX's two refusals of ``mesh=``: the device-resident path, and an effective batch the axis does not divide."""
    from quattro_tpu_torch.parallel import make_mesh

    mesh = make_mesh((3,), ("data",), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by mesh axis 'data' size 3"):
        training.train_gain_predictor(small_predictor(), dataset, None,
                                      training.TrainConfig(num_epochs=1, batch_size=16), mesh=mesh)
    with pytest.raises(ValueError, match="device-resident path"):
        training.train_gain_predictor(small_predictor(), training.DeviceGainDataset.from_host(dataset, "cpu"), None,
                                      training.TrainConfig(num_epochs=1), mesh=mesh)


def _reference_checkpoint(directory, seed=4, layers=2, d_model=16, nhead=2, ff=32, state_dim=4, control_dim=5,
                          prompt=3, target=9):
    """A checkpoint directory in the reference's layout: ``tf_model.pt`` (fp16 state dict with the reference's
    key names) and ``tf_model_normalizer.npz``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(0.2 * rng.standard_normal(shape)).half()
    state = {"state_embed.weight": t(d_model, state_dim), "state_embed.bias": t(d_model),
             "control_embed.weight": t(d_model, control_dim), "control_embed.bias": t(d_model),
             "output_linear.weight": t(control_dim, d_model), "output_linear.bias": t(control_dim),
             "target_embedding": t(target, d_model)}
    for i in range(layers):
        tl = f"transformer_decoder.layers.{i}"
        state.update({f"{tl}.self_attn.in_proj_weight": t(3 * d_model, d_model),
                      f"{tl}.self_attn.in_proj_bias": t(3 * d_model),
                      f"{tl}.self_attn.out_proj.weight": t(d_model, d_model), f"{tl}.self_attn.out_proj.bias": t(d_model),
                      f"{tl}.linear1.weight": t(ff, d_model), f"{tl}.linear1.bias": t(ff),
                      f"{tl}.linear2.weight": t(d_model, ff), f"{tl}.linear2.bias": t(d_model),
                      f"{tl}.norm1.weight": 1 + t(d_model), f"{tl}.norm1.bias": t(d_model),
                      f"{tl}.norm2.weight": 1 + t(d_model), f"{tl}.norm2.bias": t(d_model)})
    torch.save(state, str(directory / "tf_model.pt"))
    np.savez(str(directory / "tf_model_normalizer.npz"), state_dim=state_dim, control_dim=control_dim,
             d_model=d_model, nhead=nhead, num_decoder_layers=layers, dim_feedforward=ff, dropout=0.1,
             max_seq_len=32, target_len=target, prompt_len=prompt,
             x_mean=rng.standard_normal(state_dim), x_std=1 + rng.random(state_dim),
             u_mean=rng.standard_normal(control_dim), u_std=1 + rng.random(control_dim))


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """The port's loader and JAX's read the same reference-layout checkpoint to the same weights and outputs."""
    from quattro_tpu.models.torch_port import load_torch_checkpoint as jload
    from quattro_tpu_torch.models import load_torch_checkpoint

    _reference_checkpoint(tmp_path)
    ours, theirs = load_torch_checkpoint(str(tmp_path), device="cpu"), jload(str(tmp_path))
    state = ours.module.state_dict()
    for name, value in params_from_jax(_flatten_params(theirs.params)).items():
        torch.testing.assert_close(state[name], value.float(), rtol=0, atol=0)
    for a, b in zip(ours.normalizer, theirs.normalizer):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.module.hparams["dropout"] == 0.1 and not ours.module.training
    rng = np.random.default_rng(9)
    x, kk = rng.standard_normal((HORIZON + 1, 4)).astype(np.float32), rng.standard_normal((HORIZON, 5)).astype(
        np.float32)
    np.testing.assert_allclose(ours.predict_fn()(torch.from_numpy(x), torch.from_numpy(kk)).numpy(),
                               theirs.predict(x, kk), rtol=1e-5, atol=1e-5)
