"""Adam training loop for the gain predictor.

Counterpart of ``quattro_tpu/training/train.py``: z-score normalization fit
on the training split, prompt = the LAST ``prompt_len`` gain tokens, target =
the FIRST ``H - prompt_len`` tokens (the time-reversed split that matches the
backward recursion: tail exact, head predicted), Adam + MSE, early stopping
on the test loss with configurable patience and the best parameters
restored.

Three data sources share one epoch loop: an in-memory ``GainDataset``
(normalized once on the device), a streamed ``ShardDataset`` (minibatches
gathered from the shard mmap each step) and a device-resident
``DeviceGainDataset`` (minibatches gathered and normalized on the device).
Each epoch reads the host once, for its mean loss; the steps themselves
read nothing back.

Randomness comes from ``torch.Generator``s seeded from ``TrainConfig.seed``:
the epoch permutations from a CPU generator (so every data source sees the
same batches in the same order), the dropout masks from one on the model's
device. The JAX trainer's ``jax.random`` streams cannot be reproduced here.

``mesh=``: data-parallel training over a device mesh (``parallel/mesh.py``).
Each minibatch is cut over the mesh's first axis; the module and its Adam
state are replicated on the mesh's devices; each shard's gradient, weighted
by its share of the rows, is summed over the shards (an ``all_reduce`` across
processes) and every replica takes the same Adam step. The dropout masks are
drawn for the whole minibatch and cut like it, so a step equals the step
with ``mesh=None`` up to the summation order.
"""

from __future__ import annotations

import copy
import math
import os
import shutil
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from quattro_tpu_torch.models.gain_predictor import GainPredictor
from quattro_tpu_torch.models.normalizer import DataNormalizer
from quattro_tpu_torch.parallel.collectives import AxisComm
from quattro_tpu_torch.training.collect import DeviceGainDataset, GainDataset

_EVAL_CHUNK = 4096
_KEEP_CHECKPOINTS = 3
_CHECKPOINT_FILE = "state.pt"


class TrainConfig(NamedTuple):
    """The JAX trainer's fields and defaults.

    ``checkpoint_dir`` enables mid-training checkpoint/resume: the module,
    optimizer and schedule state are saved under ``checkpoint_dir/<epoch>/``
    every ``checkpoint_every`` epochs (the 3 latest kept), and training
    resumes from the latest saved epoch if the directory already holds one.
    """

    num_epochs: int = 50
    batch_size: int = 16
    learning_rate: float = 1e-3
    patience: int = 5
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    verbose: bool = False  # per-epoch loss prints
    # "constant" (fixed-lr Adam) or "cosine": cosine decay from learning_rate
    # to 0 over the full configured run.
    lr_schedule: str = "constant"


class TrainResult(NamedTuple):
    predictor: GainPredictor
    train_loss_history: np.ndarray
    test_loss_history: np.ndarray


def _cosine_factor(total: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(1, total)``: 0.5 (1 + cos(pi min(step, total) / total))."""
    return lambda step: 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))


def _make_optimizer(module: torch.nn.Module, config: TrainConfig, steps_per_epoch: int):
    """``(optimizer, scheduler)``: ``optax.adam`` as ``torch.optim.Adam``.

    Both take beta 0.9/0.999 and add eps 1e-8 outside the square root of the
    bias-corrected second moment. ``"cosine"`` adds a per-step ``LambdaLR``
    equal to ``optax.cosine_decay_schedule(lr, steps_per_epoch * num_epochs)``:
    the k-th update (from 0) takes the schedule's value at k, as optax's count
    does. ``"constant"`` has no scheduler (``None``).
    """
    optimizer = torch.optim.Adam(module.parameters(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if config.lr_schedule == "constant":
        return optimizer, None
    if config.lr_schedule == "cosine":
        total = max(steps_per_epoch * config.num_epochs, 1)
        return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, _cosine_factor(total))
    raise ValueError(f"Unknown lr_schedule: {config.lr_schedule!r} (constant|cosine)")


def _train_step(module, optimizer, scheduler, xb, pb, tb, rand=None) -> torch.Tensor:
    """One Adam step on the MSE of a minibatch; returns the loss before the step (a device scalar).

    ``rand(shape, device)`` gives the dropout uniforms (``models/transformer.py``).
    """
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((module(xb, pb, rand) - tb) ** 2)
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return loss.detach()


def _split_tokens(kk: torch.Tensor, prompt_len: int):
    """(prompt, target): the last ``prompt_len`` tokens and the first ``T - prompt_len``."""
    return kk[:, -prompt_len:, :], kk[:, : kk.shape[1] - prompt_len, :]


def _prepare(dataset: GainDataset, normalizer: DataNormalizer, prompt_len: int, state_stride: int = 1):
    """Normalized (x, prompt, target) of a whole host dataset, on the normalizer's device and in its dtype."""
    dev, dtype = normalizer.x_mean.device, normalizer.x_mean.dtype
    x = normalizer.transform_x(torch.as_tensor(np.asarray(dataset.x_data)[:, ::state_stride], dtype=dtype,
                                               device=dev))
    kk = normalizer.transform_u(torch.as_tensor(np.asarray(dataset.kk_data), dtype=dtype, device=dev))
    return (x, *_split_tokens(kk, prompt_len))


def _cast(normalizer: DataNormalizer, dtype: torch.dtype, device) -> DataNormalizer:
    return DataNormalizer(*(torch.as_tensor(a, dtype=dtype, device=device) for a in normalizer))


def train_gain_predictor(
    predictor: GainPredictor,
    train_data,
    test_data=None,
    config: TrainConfig = TrainConfig(),
    mesh=None,
) -> TrainResult:
    """Fit the predictor; returns a new ``GainPredictor`` (``predictor`` itself is left as it was).

    ``train_data``/``test_data``: an in-memory ``GainDataset``, a streamed
    ``ShardDataset`` or a ``DeviceGainDataset`` (the device-resident path).
    Training runs on the predictor's device, in its parameters' dtype.
    ``mesh``: a ``parallel.mesh.Mesh`` for data-parallel training (the
    minibatch cut over its first axis, the parameters replicated; see the
    module docstring); not with a ``DeviceGainDataset``.
    """
    if isinstance(train_data, DeviceGainDataset):
        if mesh is not None:
            raise ValueError(
                "mesh= data parallelism is not wired into the device-resident path; pass a "
                "GainDataset/ShardDataset for data-parallel training, or mesh=None here"
            )
        return _train_device_resident(predictor, train_data, test_data, config)

    param = next(predictor.module.parameters())
    dtype, dev = param.dtype, param.device
    prompt_len, stride = predictor.prompt_len, predictor.state_stride
    streamed = not isinstance(train_data, GainDataset)
    if streamed:
        normalizer = _cast(DataNormalizer(*train_data.feature_stats()), dtype, dev)
        num_rows = len(train_data)
    else:
        fitted = DataNormalizer.fit(torch.as_tensor(np.asarray(train_data.x_data), device=dev),
                                    torch.as_tensor(np.asarray(train_data.kk_data), device=dev))
        normalizer = _cast(fitted, dtype, dev)
        x, prompt, target = _prepare(train_data, normalizer, prompt_len, stride)
        num_rows = x.shape[0]
    if mesh is not None:
        axis = mesh.axis_names[0]
        # The batch actually fed: with fewer rows than batch_size the one batch per epoch is the whole dataset.
        effective_batch = min(config.batch_size, num_rows)
        if effective_batch % mesh.shape[axis] != 0:
            raise ValueError(
                f"effective batch {effective_batch} (batch_size {config.batch_size}, dataset rows {num_rows}) "
                f"not divisible by mesh axis {axis!r} size {mesh.shape[axis]}"
            )

    def streamed_batch(source, idx):
        xb_np, kb_np = source.gather(np.asarray(idx))
        xb = normalizer.transform_x(torch.as_tensor(xb_np[:, ::stride], dtype=dtype, device=dev))
        kk = normalizer.transform_u(torch.as_tensor(kb_np, dtype=dtype, device=dev))
        return (xb, *_split_tokens(kk, prompt_len))

    if streamed:
        get_batch = lambda idx: streamed_batch(train_data, idx)  # noqa: E731
    else:
        get_batch = lambda idx: (x[idx], prompt[idx], target[idx])  # noqa: E731

    test_loss = None
    if test_data is not None:
        if isinstance(test_data, GainDataset):
            xt, pt, tt = _prepare(test_data, normalizer, prompt_len, stride)
            test_batch, n_test, test_dev = (lambda idx: (xt[idx], pt[idx], tt[idx])), xt.shape[0], dev
        else:
            test_batch, n_test, test_dev = (lambda idx: streamed_batch(test_data, idx)), len(test_data), "cpu"

        def test_loss(module):
            total = torch.zeros((), dtype=dtype, device=dev)
            for start in range(0, n_test, _EVAL_CHUNK):
                idx = torch.arange(start, min(start + _EVAL_CHUNK, n_test), device=test_dev)
                xb, pb, tb = test_batch(idx)
                total = total + torch.mean((module(xb, pb) - tb) ** 2) * len(idx)
            return float(total / n_test)

    return _fit(predictor, normalizer, num_rows, get_batch, test_loss, config,
                index_device=torch.device("cpu") if streamed else dev, mesh=mesh)


def _fit_normalizer_flat(x_flat, kk_flat, x_shape, kk_shape) -> DataNormalizer:
    """``DataNormalizer.fit`` over flat-layout (N, T*F) rows without reshaping the full arrays.

    Per-column first and second moments (float32) reduce over the row axis
    on the device; the small (T*F,) moment vectors are reshaped on the host
    and averaged over T. Equal in exact arithmetic to ``fit``'s mean/std over
    axes (0, 1), since every t has the same row count.
    """

    def stats(flat, shape):
        af = flat.to(torch.float32)
        m1, m2 = (v.cpu().numpy().reshape(shape) for v in (af.mean(dim=0), (af * af).mean(dim=0)))
        mean = m1.mean(axis=0)
        var = np.maximum(m2.mean(axis=0) - mean * mean, 0.0)
        return torch.as_tensor(mean), torch.as_tensor(np.sqrt(var) + 1e-6)

    x_mean, x_std = stats(x_flat, x_shape)
    u_mean, u_std = stats(kk_flat, kk_shape)
    return DataNormalizer(x_mean=x_mean, x_std=x_std, u_mean=u_mean, u_std=u_std)


def _train_device_resident(
    predictor: GainPredictor,
    train_data: DeviceGainDataset,
    test_data: Optional[DeviceGainDataset],
    config: TrainConfig,
) -> TrainResult:
    """The device-resident path: minibatches gathered from the flat device rows and normalized per step.

    The raw dataset is the only full-size tensor on the device (no second,
    normalized copy); each epoch reads the host once, for its mean loss.
    Semantics match the in-memory path (normalizer from the training split,
    the prompt/target split, Adam + MSE, early stopping with the best
    parameters restored), and on the same permutation it takes the same
    batches. The test loss is the mean over equal chunks of up to 4,096 rows
    (a tail shorter than a chunk is left out, as in the JAX trainer).
    """
    param = next(predictor.module.parameters())
    dtype, dev = param.dtype, param.device
    prompt_len, stride = predictor.prompt_len, predictor.state_stride
    x_shape, kk_shape = train_data.x_row_shape, train_data.kk_row_shape
    normalizer = _cast(_fit_normalizer_flat(train_data.x_flat, train_data.kk_flat, x_shape, kk_shape), dtype, dev)

    def norm_batch(source: DeviceGainDataset, ib):
        xrows = source.x_flat[ib].reshape((ib.shape[0],) + x_shape)
        kkrows = source.kk_flat[ib].reshape((ib.shape[0],) + kk_shape)
        xb = normalizer.transform_x(xrows[:, ::stride].to(dtype))
        kk = normalizer.transform_u(kkrows.to(dtype))
        return (xb, *_split_tokens(kk, prompt_len))

    test_loss = None
    if test_data is not None:
        n_test = len(test_data)
        chunk = min(_EVAL_CHUNK, n_test)
        eval_idx = torch.arange((n_test // chunk) * chunk, device=dev).reshape(-1, chunk)

        def test_loss(module):
            total = torch.zeros((), dtype=dtype, device=dev)
            for ib in eval_idx:
                xb, pb, tb = norm_batch(test_data, ib)
                total = total + torch.mean((module(xb, pb) - tb) ** 2)
            return float(total / eval_idx.shape[0])

    return _fit(predictor, normalizer, len(train_data), lambda ib: norm_batch(train_data, ib), test_loss, config,
                index_device=dev)


def _fit(predictor: GainPredictor, normalizer: DataNormalizer, num_rows: int, get_batch, test_loss,
         config: TrainConfig, index_device, mesh=None) -> TrainResult:
    """The epoch loop shared by every data source.

    ``get_batch(idx)`` returns the normalized ``(x, prompt, target)`` of the
    rows ``idx`` (on ``index_device``); ``test_loss(module)`` the test loss as
    a float, or ``None`` without test data. Each epoch takes
    ``max(num_rows // batch, 1)`` batches of ``batch = min(batch_size,
    num_rows)`` rows of a fresh permutation. With a ``mesh`` each step is a
    ``_DataParallel`` step.
    """
    module = copy.deepcopy(predictor.module)
    param = next(module.parameters())
    batch = min(config.batch_size, num_rows)
    steps_per_epoch = max(num_rows // batch, 1)
    optimizer, scheduler = _make_optimizer(module, config, steps_per_epoch)
    perm_gen = torch.Generator().manual_seed(config.seed)
    dropout_gen = torch.Generator(device=param.device).manual_seed(config.seed)
    rand = lambda shape, device: torch.rand(shape, generator=dropout_gen, device=device)  # noqa: E731

    start_epoch = 0
    if config.checkpoint_dir is not None:
        latest = _latest_checkpoint(config.checkpoint_dir)
        if latest is not None:
            state = torch.load(os.path.join(config.checkpoint_dir, str(latest), _CHECKPOINT_FILE),
                               map_location=param.device)
            module.load_state_dict(state["module"])
            optimizer.load_state_dict(state["optimizer"])
            if scheduler is not None and state["scheduler"] is not None:
                scheduler.load_state_dict(state["scheduler"])
            start_epoch = state["epoch"]
    parallel = None if mesh is None else _DataParallel(module, optimizer, scheduler, mesh, config, steps_per_epoch)

    best_loss = float("inf")
    best_state = _snapshot(module)
    no_improvement = 0
    train_hist, test_hist = [], []
    for epoch in range(start_epoch, config.num_epochs):
        perm = torch.randperm(num_rows, generator=perm_gen)
        epoch_idx = perm[: steps_per_epoch * batch].reshape(steps_per_epoch, batch).to(index_device)
        module.train()
        total = torch.zeros((), dtype=param.dtype, device=param.device)
        for idx in epoch_idx:
            xb, pb, tb = get_batch(idx)
            if parallel is None:
                total = total + _train_step(module, optimizer, scheduler, xb, pb, tb, rand)
            else:
                total = total + parallel.step(xb, pb, tb, _ShardDraws(dropout_gen, xb.shape[0]))
        module.eval()
        train_hist.append(float(total / steps_per_epoch))  # the epoch's one host read
        if config.verbose:
            print(f"epoch {epoch + 1}/{config.num_epochs}: train {train_hist[-1]:.6f}", flush=True)

        if config.checkpoint_dir is not None and (epoch + 1) % config.checkpoint_every == 0:
            _save_checkpoint(config.checkpoint_dir, epoch + 1, module, optimizer, scheduler)

        if test_loss is not None:
            with torch.no_grad():
                loss = test_loss(module)
            test_hist.append(loss)
            if loss < best_loss:
                best_loss, best_state, no_improvement = loss, _snapshot(module), 0
            else:
                no_improvement += 1
            if no_improvement >= config.patience:
                break
    if test_loss is not None:  # early stopped or not, the best test loss's parameters
        module.load_state_dict(best_state)

    trained = GainPredictor(module, normalizer, predictor.state_stride)
    return TrainResult(trained, np.asarray(train_hist), np.asarray(test_hist))


class _ShardDraws:
    """The dropout draws of a whole minibatch, handed to each shard as its rows.

    The model draws its masks site by site through ``rand``
    (``models/transformer.py``). The first shard to reach a site draws that
    site's uniforms for the whole minibatch from the trainer's generator, in
    the order and the shapes of the step with ``mesh=None``; every shard
    takes its rows of them.
    """

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator, self.batch = generator, batch
        self.draws = []
        self.rows, self.site = slice(None), 0

    def shard(self, rows: slice) -> "_ShardDraws":
        """Start a shard's forward pass over the minibatch's ``rows``."""
        self.rows, self.site = rows, 0
        return self

    def rand(self, shape, device) -> torch.Tensor:
        if self.site == len(self.draws):
            self.draws.append(torch.rand((self.batch,) + tuple(shape[1:]), generator=self.generator,
                                         device=self.generator.device))
        draw = self.draws[self.site][self.rows]
        self.site += 1
        return draw.to(device)


class _DataParallel:
    """The module replicated on the devices of the mesh's first axis, each replica stepped with the summed gradient.

    ``module`` (with ``optimizer`` and ``scheduler``) stays the replica on its
    own device; every other device the shards of this process use gets a
    copy with a copy of the optimizer state. A step cuts the minibatch into
    the axis's shards, takes each shard's gradient of its loss weighted by
    its share of the rows, sums them with ``AxisComm.psum`` and steps every
    replica with the sum.
    """

    def __init__(self, module, optimizer, scheduler, mesh, config: TrainConfig, steps_per_epoch: int):
        axis = mesh.axis_names[0]
        self.mesh = mesh
        self.comm = AxisComm(mesh, axis, mesh.coords((axis,)))
        self.home = next(module.parameters()).device
        self.replicas = {self.home: (module, optimizer, scheduler)}
        for c in self.comm.local:
            dev = mesh.device(c)
            if dev not in self.replicas:
                copy_module = copy.deepcopy(module).to(dev)
                copy_opt, copy_sched = _make_optimizer(copy_module, config, steps_per_epoch)
                copy_opt.load_state_dict(optimizer.state_dict())
                if copy_sched is not None:
                    copy_sched.load_state_dict(scheduler.state_dict())
                self.replicas[dev] = (copy_module, copy_opt, copy_sched)

    def step(self, xb, pb, tb, draws: _ShardDraws) -> torch.Tensor:
        """One Adam step on the minibatch's MSE; returns the loss before the step (a scalar on the home device)."""
        batch = xb.shape[0]
        rows = batch // self.comm.size
        values = {}
        for c in self.comm.local:
            dev = self.mesh.device(c)
            module = self.replicas[dev][0]
            sl = slice(self.comm.axis_index(c) * rows, (self.comm.axis_index(c) + 1) * rows)
            pred = module(xb[sl].to(dev), pb[sl].to(dev), draws.shard(sl).rand)
            loss = torch.mean((pred - tb[sl].to(dev)) ** 2) * (rows / batch)
            params = list(module.parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            values[c] = ([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)], loss.detach())
        summed = self.comm.psum(values)
        grads, loss = summed[self.comm.local[0]]
        for dev, (module, optimizer, scheduler) in self.replicas.items():
            optimizer.zero_grad(set_to_none=True)
            for p, g in zip(module.parameters(), grads):
                p.grad = g.to(dev)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return loss.to(self.home)


def _snapshot(module: torch.nn.Module):
    return {name: value.detach().clone() for name, value in module.state_dict().items()}


def _latest_checkpoint(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    epochs = [int(name) for name in os.listdir(directory)
              if name.isdigit() and os.path.exists(os.path.join(directory, name, _CHECKPOINT_FILE))]
    return max(epochs, default=None)


def _save_checkpoint(directory: str, epoch: int, module, optimizer, scheduler) -> None:
    """``torch.save`` of the module, optimizer and schedule state under ``directory/<epoch>/``; keeps the 3 latest."""
    path = os.path.join(os.path.abspath(directory), str(epoch))
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _CHECKPOINT_FILE)
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save({"epoch": epoch, "module": module.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": None if scheduler is None else scheduler.state_dict()}, tmp)
    os.replace(tmp, target)  # a cut save leaves the previous checkpoint the latest
    saved = sorted(int(name) for name in os.listdir(directory) if name.isdigit())
    for old in saved[:-_KEEP_CHECKPOINTS]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
