"""Batched on-device training-data collection.

Counterpart of ``quattro_tpu/training/collect.py``. Every (initial state,
control step, iLQR iteration) triple of closed-loop MPC sweeps yields a
training row: the state trajectory at the iteration's start (all H+1 rows,
what the hybrid solver feeds the model) and its H gain tokens.

Where JAX runs ``vmap(ilqr_solve_with_logs)`` inside a ``lax.scan`` over the
control steps, the port runs a loop of control steps over the logged batched
solve (``parallel/batch.py::batched_ilqr_solve_with_logs``): per-lane early
exit, finished lanes frozen, each trip's entry written at the trip index. On
the card its "fused" backend launches K4 once per trip, and K7 once per trip
with ``linesearch="fused"``. The rows stay on the device until the host asks
for them (``device_resident=True`` never does).

Randomness comes from explicit ``torch.Generator``s where JAX takes a key.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from quattro_tpu_torch.control.mpc import shift_warm_start
from quattro_tpu_torch.device import DeviceLike, resolve_device
from quattro_tpu_torch.parallel.batch import batched_ilqr_solve_with_logs
from quattro_tpu_torch.solver.ilqr import ILQRConfig, ILQRLogs, empty_logs, ilqr_solve_with_logs
from quattro_tpu_torch.utils.metrics import _host


class CollectStats(NamedTuple):
    """Row accounting of a collection run.

    ``rows_valid`` counts every valid (executed-iteration) row the solver
    produced; ``rows_kept`` is what survived the compaction cap. A nonzero
    ``dropped_fraction`` means ``compact_iters`` was set below the mean
    accepted-iteration count and the dataset is skewed toward easy
    (few-iteration) control steps; keep it under ~1% for training runs.
    ``trips`` counts the batched solver's trips summed over control steps and
    chunks (one K4 launch each on the "fused" backend; 0 where not counted).
    """

    rows_kept: int
    rows_valid: int
    rows_dropped: int
    trips: int = 0

    @property
    def dropped_fraction(self) -> float:
        return self.rows_dropped / max(self.rows_valid, 1)


class GainDataset(NamedTuple):
    """Stacked training rows for the gain predictor (host arrays)."""

    x_data: np.ndarray  # (N, H+1, n) raw state trajectories (iteration start)
    kk_data: np.ndarray  # (N, H, m*(1+n)) packed gain tokens
    stats: Optional[CollectStats] = None  # row accounting (None for loaded data)


class DeviceGainDataset:
    """Training rows held as device tensors.

    Collection (``collect_gain_dataset(device_resident=True)``) appends
    compacted device slices, the trainer's device-resident path gathers its
    minibatches on the device, and no row crosses to the host.

    Rows are stored flat, ``x_flat (N, (H+1)*n)`` and ``kk_flat (N, H*d)``,
    with their row shapes beside them; the trainer reshapes each gathered
    minibatch.
    """

    def __init__(self, x_data: torch.Tensor, kk_data: torch.Tensor):
        if x_data.shape[0] != kk_data.shape[0]:
            raise ValueError(f"row mismatch: x_data {x_data.shape[0]} vs kk_data {kk_data.shape[0]}")
        if x_data.dim() != 3 or kk_data.dim() != 3:
            raise ValueError(
                "DeviceGainDataset(x_data, kk_data) takes (N, T, dim) rows; use from_flat() for flat storage"
            )
        self.x_row_shape = tuple(x_data.shape[1:])
        self.kk_row_shape = tuple(kk_data.shape[1:])
        self.x_flat = x_data.reshape(x_data.shape[0], -1)
        self.kk_flat = kk_data.reshape(kk_data.shape[0], -1)
        self.stats: Optional[CollectStats] = None

    @classmethod
    def from_flat(cls, x_flat, kk_flat, x_row_shape, kk_row_shape):
        ds = cls.__new__(cls)
        if x_flat.shape[0] != kk_flat.shape[0]:
            raise ValueError(f"row mismatch: x_flat {x_flat.shape[0]} vs kk_flat {kk_flat.shape[0]}")
        ds.x_flat, ds.kk_flat = x_flat, kk_flat
        ds.x_row_shape = tuple(x_row_shape)
        ds.kk_row_shape = tuple(kk_row_shape)
        ds.stats = None
        return ds

    @classmethod
    def from_host(cls, dataset: GainDataset, device: DeviceLike = None):
        """Upload a host dataset, in the flat layout, for the device-resident trainer."""
        dev = resolve_device(device)
        x = np.asarray(dataset.x_data)
        kk = np.asarray(dataset.kk_data)
        ds = cls.from_flat(
            torch.from_numpy(np.ascontiguousarray(x.reshape(x.shape[0], -1))).to(dev),
            torch.from_numpy(np.ascontiguousarray(kk.reshape(kk.shape[0], -1))).to(dev),
            x.shape[1:],
            kk.shape[1:],
        )
        ds.stats = dataset.stats
        return ds

    @property
    def x_data(self) -> torch.Tensor:
        """Rows as (N, H+1, n)."""
        return self.x_flat.reshape((-1,) + self.x_row_shape)

    @property
    def kk_data(self) -> torch.Tensor:
        """Rows as (N, H, m*(1+n))."""
        return self.kk_flat.reshape((-1,) + self.kk_row_shape)

    def __len__(self) -> int:
        return int(self.x_flat.shape[0])

    def split(self, train_frac: float = 0.8, seed: int = 42, perm: Optional[torch.Tensor] = None):
        """Shuffled train/test split on the device: the first ``train_frac`` of the permutation trains.

        ``perm`` defaults to ``torch.randperm`` from a CPU generator seeded
        with ``seed``; pass one to split on a given permutation.
        """
        if perm is None:
            perm = torch.randperm(len(self), generator=torch.Generator().manual_seed(seed))
        perm = torch.as_tensor(perm, dtype=torch.int64).to(self.x_flat.device)
        cut = int(len(self) * train_frac)
        tr, te = perm[:cut], perm[cut:]
        return (
            DeviceGainDataset.from_flat(self.x_flat[tr], self.kk_flat[tr], self.x_row_shape, self.kk_row_shape),
            DeviceGainDataset.from_flat(self.x_flat[te], self.kk_flat[te], self.x_row_shape, self.kk_row_shape),
        )

    def to_host(self) -> GainDataset:
        """Copy the rows to the host (archival; the trainer does not need it)."""
        return GainDataset(
            _host(self.x_flat).reshape((-1,) + self.x_row_shape),
            _host(self.kk_flat).reshape((-1,) + self.kk_row_shape),
        )


def _compact_valid_rows(x_log, k_log, big_k_log, valid, *, cap: int, flatten: bool):
    """Device-side row compaction shared by the collection sweeps.

    The inputs share their leading axes with ``valid`` (e.g. ``(chunk,
    sim_steps * max_iter)`` or ``(sim_steps, plants, max_iter)``); rows are
    flattened over them, gain tokens packed in the solver's interleaved
    layout, valid rows stably sorted to the front, and the first ``cap`` rows
    returned with the valid count (a device scalar). ``flatten=True`` also
    reshapes each row to 1-D (the ``DeviceGainDataset`` storage layout).
    """
    lead = valid.dim()
    xf = x_log.reshape((-1,) + tuple(x_log.shape[lead:]))
    kf = k_log.reshape((-1,) + tuple(k_log.shape[lead:]))
    bf = big_k_log.reshape((-1,) + tuple(big_k_log.shape[lead:]))
    vf = valid.reshape(-1)
    kkf = torch.cat([kf[..., None], bf], dim=-1).reshape(kf.shape[0], kf.shape[1], -1)
    # A cap beyond the log capacity (compact_iters > max_iter) cannot yield more rows than exist.
    cap = min(cap, int(vf.shape[0]))
    # Stable sort on ~valid: valid rows first, original order kept.
    order = torch.argsort((~vf).to(torch.int32), stable=True)[:cap]
    if flatten:
        return xf[order].reshape(cap, -1), kkf[order].reshape(cap, -1), vf.sum()
    return xf[order], kkf[order], vf.sum()


def _pack_rows(k_rows: np.ndarray, big_k_rows: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``solver.ilqr.pack_gain_tokens`` for (rows, H, ...) batches.

    The interleaved per-channel token layout ``[k_0, K[0, :], k_1, K[1, :],
    ...]``: training rows must share the solver's prompt/unpack layout or the
    hybrid solve reads scrambled gains (fatal for m > 1).
    """
    rows, horizon, _ = k_rows.shape
    packed = np.concatenate([k_rows[..., None], big_k_rows], axis=-1)
    return packed.reshape(rows, horizon, -1)


def _lhs_from_draws(lower: torch.Tensor, upper: torch.Tensor, jitter: torch.Tensor,
                    perms: torch.Tensor) -> torch.Tensor:
    """The Latin-hypercube transform of given draws.

    ``jitter (dim, num)`` uniform in [0, 1), ``perms (dim, num)`` one
    permutation of ``range(num)`` per dimension: sample i of dimension d lies
    in bin ``perms[d, i]`` at offset ``jitter[d, perms[d, i]]``.
    """
    dim, num = jitter.shape
    bins = (torch.arange(num, dtype=jitter.dtype, device=jitter.device) + jitter).T  # (num, dim)
    unit = torch.stack([bins[perms[d], d] / num for d in range(dim)], dim=1)  # (num, dim) in [0, 1)
    return lower + unit * (upper - lower)


def lhs_initial_states(
    generator: torch.Generator,
    lower: torch.Tensor,
    upper: torch.Tensor,
    num_samples: int,
) -> torch.Tensor:
    """Latin-hypercube sample of initial conditions, (num_samples, dim) on ``lower``'s device.

    Stratified one-point-per-bin sampling with an independent permutation per
    dimension; the draws come from ``generator`` (on its own device).
    """
    dim = lower.shape[0]
    jitter = torch.rand((dim, num_samples), generator=generator, dtype=lower.dtype, device=generator.device)
    perms = torch.stack([torch.randperm(num_samples, generator=generator, device=generator.device)
                         for _ in range(dim)])
    return _lhs_from_draws(lower, upper, jitter.to(lower.device), perms.to(lower.device))


def _perturb_from_draws(nominal, rel_scale: float, draws):
    """``leaf[None] * (1 + rel_scale * draw)`` for each leaf of ``nominal`` and its draw in [-1, 1) (tensors)."""
    leaves, spec = tree_flatten(nominal)
    out = [torch.as_tensor(leaf, dtype=draw.dtype, device=draw.device)[None] * (1.0 + rel_scale * draw)
           for leaf, draw in zip(leaves, draws)]
    return tree_unflatten(out, spec)


def perturb_params(generator: torch.Generator, nominal, rel_scale: float, num: int, device: DeviceLike = None):
    """Per-trajectory multiplicative domain randomization of plant parameters.

    Every leaf of ``nominal`` (a params NamedTuple of scalars or tensors) gets
    an independent uniform factor in ``[1 - rel_scale, 1 + rel_scale)`` per
    sample: the result has the same structure with a leading ``(num,)`` axis
    on every leaf (in the default float dtype), ready for
    ``collect_gain_dataset(..., plant_params_batch=...)``.
    """
    dev = resolve_device(device)
    leaves, _ = tree_flatten(nominal)
    draws = [(2.0 * torch.rand((num,) + tuple(torch.as_tensor(leaf).shape), generator=generator,
                               device=generator.device) - 1.0).to(dev)
             for leaf in leaves]
    return _perturb_from_draws(nominal, rel_scale, draws)


def collect_gain_dataset(
    dynamics: Callable,
    cost: Callable,
    final_cost: Callable,
    x0_batch: torch.Tensor,  # (B, n) initial plant states
    horizon: int,
    control_dim: int,
    sim_steps: int,
    config: ILQRConfig = ILQRConfig(),
    plant_dynamics: Optional[Callable] = None,
    plant_params_batch=None,
    chunk_size: Optional[int] = None,
    log_budget_bytes: int = 2 << 30,
    compact_iters: Optional[int] = None,
    device_resident: bool = False,
    verbose: bool = False,
    riccati_backend: str = "auto",
):
    """Closed-loop MPC sweeps that log every iLQR iteration as a training row.

    For each initial state: ``sim_steps`` receding-horizon control steps
    (warm-started, first control applied to the plant) through the logged
    batched solve, on ``x0_batch``'s device and in its dtype.
    ``plant_dynamics`` defaults to the solver's model; a distinct plant
    reproduces model mismatch. ``riccati_backend`` is the batched solve's
    (``"auto"``: "fused" for float32 CUDA batches of 8 or more, else "vmap").

    ``plant_params_batch`` (e.g. from :func:`perturb_params`): leaves with a
    leading ``(B,)`` axis, per-trajectory plant parameters;
    ``plant_dynamics`` then takes ``(x, u, params_row)`` and runs per lane
    under ``torch.func.vmap``, while the solver keeps the nominal model.

    The log buffers are ``(B, sim_steps * max_iter, ...)``; the batch runs
    in chunks sized so that the x, k, K and valid buffers stay under
    ``log_budget_bytes`` (``chunk_size`` overrides; a chunk size that does
    not divide the batch is lowered until it does).

    ``compact_iters``: compact rows on the device (valid rows stably sorted
    to the front, gain tokens packed) and keep at most ``chunk * sim_steps *
    compact_iters`` rows per chunk; rows beyond the cap are dropped with a
    message and counted in ``stats``.

    ``device_resident``: keep the rows on the device and return a
    :class:`DeviceGainDataset` (requires ``compact_iters``, since the row
    filter is otherwise host-side).

    Returns a :class:`GainDataset` (host arrays, invalid iterations filtered)
    or a :class:`DeviceGainDataset`, with ``stats``.
    """
    if device_resident and compact_iters is None:
        raise ValueError("device_resident=True requires compact_iters")
    if plant_dynamics is None:
        if plant_params_batch is not None:
            raise ValueError("plant_params_batch requires an explicit plant_dynamics(x, u, params)")
        plant_dynamics = dynamics

    batch, n = x0_batch.shape
    dtype, device = x0_batch.dtype, x0_batch.device
    # The lanes are one batch: the backward form is chosen for the whole batch width.
    if config.parallel_riccati is None and config.riccati == "auto":
        config = config._replace(batch_hint=max(config.batch_hint, batch))
    mi = config.max_iter
    plant = vmap(plant_dynamics)

    def sweep(lo, hi):
        x_plant = x0_batch[lo:hi]
        theta = None if plant_params_batch is None else tree_map(lambda t: t[lo:hi], plant_params_batch)
        logs = empty_logs((hi - lo, sim_steps * mi), horizon, n, control_dim, dtype, device)
        u_warm = torch.zeros((hi - lo, horizon, control_dim), dtype=dtype, device=device)
        trips = 0
        for step in range(sim_steps):
            step_logs = ILQRLogs(*(buf[:, step * mi:(step + 1) * mi] for buf in logs))
            sol, _ = batched_ilqr_solve_with_logs(dynamics, cost, final_cost, x_plant, u_warm, config,
                                                  riccati_backend, step_logs)
            trips += int(sol.iterations.max())
            u_applied = sol.u_seq[:, 0]
            x_next = plant(x_plant, u_applied) if theta is None else plant(x_plant, u_applied, theta)
            # Param leaves may sit at a wider dtype; the plant state keeps the solver's.
            x_plant = x_next.to(dtype)
            u_warm = vmap(shift_warm_start)(sol.u_seq)
        return (logs.x_seq, logs.k_seq, logs.big_k_seq, logs.valid), trips

    if chunk_size is None:
        itemsize = torch.finfo(dtype).bits // 8
        bytes_per_traj = (
            sim_steps * mi * ((horizon + 1) * n + horizon * control_dim * (1 + n) + 1) * itemsize
        )
        chunk_size = max(1, min(batch, log_budget_bytes // max(bytes_per_traj, 1)))
    while batch % chunk_size != 0:
        chunk_size -= 1

    cap = None if compact_iters is None else chunk_size * sim_steps * compact_iters
    xs_out, kk_out = [], []
    rows_valid = rows_kept = trips = 0
    for lo in range(0, batch, chunk_size):
        if verbose:
            print(f"collect_gain_dataset: chunk {lo // chunk_size + 1}/{batch // chunk_size} "
                  f"(size {chunk_size}) @ {time.time():.0f}", flush=True)
        swept, chunk_trips = sweep(lo, lo + chunk_size)
        trips += chunk_trips
        if cap is not None:
            x_c, kk_c, n_valid = _compact_valid_rows(*swept, cap=cap, flatten=device_resident)
            take = int(n_valid)  # the chunk's one host read of the rows
            rows_valid += take
            if take > cap:
                print(f"collect_gain_dataset: chunk at {lo} produced {take} valid rows > compact cap {cap}; "
                      f"dropping {take - cap}", flush=True)
                take = cap
            rows_kept += take
            if device_resident:
                xs_out.append(x_c[:take])
                kk_out.append(kk_c[:take])
            else:
                xs_out.append(_host(x_c[:take]))
                kk_out.append(_host(kk_c[:take]))
            continue
        x_log, k_log, big_k_log, valid = (_host(t) for t in swept)
        x_rows = x_log.reshape((-1,) + x_log.shape[2:])
        k_rows = k_log.reshape((-1,) + k_log.shape[2:])
        big_k_rows = big_k_log.reshape((-1,) + big_k_log.shape[2:])
        mask = valid.reshape(-1)
        rows_valid += int(mask.sum())
        rows_kept += int(mask.sum())
        xs_out.append(x_rows[mask])
        kk_out.append(_pack_rows(k_rows[mask], big_k_rows[mask]))
    stats = CollectStats(rows_kept=rows_kept, rows_valid=rows_valid, rows_dropped=rows_valid - rows_kept,
                         trips=trips)
    if device_resident:
        ds = DeviceGainDataset.from_flat(torch.cat(xs_out), torch.cat(kk_out), (horizon + 1, n),
                                         (horizon, control_dim * (1 + n)))
        ds.stats = stats
        return ds
    return GainDataset(x_data=np.concatenate(xs_out), kk_data=np.concatenate(kk_out), stats=stats)


def _state_dtype(x0_batch) -> torch.dtype:
    """The host collectors' solve dtype: the initial states' float dtype (float32 unless they are float64)."""
    return torch.float64 if np.asarray(x0_batch).dtype == np.float64 else torch.float32


def collect_gain_dataset_host(
    reset_fn: Callable,
    read_fn: Callable,
    apply_fn: Callable,
    step_fn: Callable,
    dynamics: Callable,
    cost: Callable,
    final_cost: Callable,
    x0_batch,
    horizon: int,
    control_dim: int,
    sim_steps: int,
    config: ILQRConfig = ILQRConfig(),
    substeps: int = 1,
    shard_path: Optional[str] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> GainDataset:
    """Host-loop collection against an external plant (e.g. a MuJoCo bridge), one run at a time.

    Rows come from closed-loop runs of the real (mismatched) plant, not the
    solver's model. The solve (on ``device``, in ``x0_batch``'s float dtype:
    float32 for float32 states, as the JAX package always solves) is the
    single ``ilqr_solve_with_logs``; only the plant step and the state read
    cross the host boundary.

    Plant protocol:
      ``reset_fn(x0_row)`` put the plant at the initial condition;
      ``read_fn() -> (n,)`` solver-convention state;
      ``apply_fn(u (m,))`` write actuators (sign conventions inside);
      ``step_fn()`` advance one engine step. ``substeps`` holds each control
      for that many engine steps.

    ``shard_path``: append one ``.qtshard`` record per completed run, so a
    crash loses at most the current run.
    """
    dev = resolve_device(device)
    dtype = _state_dtype(x0_batch)
    writer = None
    if shard_path is not None:
        from quattro_tpu_torch.io import ShardWriter

        writer = ShardWriter(shard_path)

    rows_x, rows_kk = [], []
    try:
        for run, x0 in enumerate(np.asarray(x0_batch)):
            reset_fn(x0)
            u_warm = torch.zeros((horizon, control_dim), dtype=dtype, device=dev)
            run_x, run_kk = [], []
            for _ in range(sim_steps):
                x_now = torch.as_tensor(np.asarray(read_fn()), dtype=dtype, device=dev)
                sol, logs = ilqr_solve_with_logs(dynamics, cost, final_cost, x_now, u_warm, config)
                valid = _host(logs.valid)
                if valid.any():
                    run_x.append(_host(logs.x_seq)[valid])
                    run_kk.append(_pack_rows(_host(logs.k_seq)[valid], _host(logs.big_k_seq)[valid]))
                apply_fn(_host(sol.u_seq[0]))
                for _ in range(substeps):
                    step_fn()
                u_warm = shift_warm_start(sol.u_seq)
            x_run = np.concatenate(run_x)
            kk_run = np.concatenate(run_kk)
            if writer is not None:
                writer.append({"x_data": x_run, "kk_data": kk_run})
            if verbose:
                print(f"run {run + 1}/{len(x0_batch)}: {x_run.shape[0]} rows", flush=True)
            rows_x.append(x_run)
            rows_kk.append(kk_run)
    finally:
        if writer is not None:
            writer.close()
    return GainDataset(np.concatenate(rows_x), np.concatenate(rows_kk))


def collect_gain_dataset_host_batched(
    plants,
    dynamics: Callable,
    cost: Callable,
    final_cost: Callable,
    x0_batch,
    horizon: int,
    control_dim: int,
    sim_steps: int,
    config: ILQRConfig = ILQRConfig(),
    substeps: int = 1,
    compact_iters: int = 3,
    shard_path: Optional[str] = None,
    policy: Optional[Callable] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> GainDataset:
    """Batched host-loop collection against P external plants in lockstep.

    ``plants``: a sequence of ``(reset_fn, read_fn, apply_fn, step_fn)``
    adapters (the :func:`collect_gain_dataset_host` protocol), one per
    lockstep lane; ``x0_batch`` must be a multiple of ``len(plants)``. Every
    control step is one logged batched solve of the P plants' states (on
    ``device``, in ``x0_batch``'s float dtype as in the sequential collector).

    ``policy``: optional ``(x_batch (P, n), u_warm (P, H, m)) -> (u_applied
    (P, m), u_warm_next (P, H, m))`` that drives the plants while the exact
    logged solve still labels every visited state with its iteration rows
    (DAgger-style on-policy collection). ``None`` applies the exact solve's
    own first control.

    Per-step logs stay on the device; once a round's ``sim_steps`` finish,
    rows are compacted on the device (valid-sort + token pack, cap ``P *
    sim_steps * compact_iters``) and only the valid rows are copied to the
    host. Rows beyond the cap are dropped and counted in ``stats``.

    ``shard_path``: append one ``.qtshard`` record per completed round.
    """
    dev = resolve_device(device)
    dtype = _state_dtype(x0_batch)
    num_plants = len(plants)
    x0_np = np.asarray(x0_batch)
    batch = x0_np.shape[0]
    if batch % num_plants != 0:
        raise ValueError(
            f"x0_batch rows ({batch}) must be a multiple of len(plants) ({num_plants}) — lockstep rounds need "
            "full lanes"
        )

    def batched_step(x_now, u_warm):
        sol, logs = batched_ilqr_solve_with_logs(dynamics, cost, final_cost, x_now, u_warm, config)
        if policy is not None:
            # The policy drives the plant and owns the warm-start stream;
            # the exact solve only labels the visited states.
            u_applied, u_next = policy(x_now, u_warm)
        else:
            u_applied, u_next = sol.u_seq[:, 0], vmap(shift_warm_start)(sol.u_seq)
        return u_applied, u_next, (logs.x_seq, logs.k_seq, logs.big_k_seq, logs.valid)

    cap = num_plants * sim_steps * compact_iters
    writer = None
    if shard_path is not None:
        from quattro_tpu_torch.io import ShardWriter

        writer = ShardWriter(shard_path)

    xs_out, kk_out = [], []
    rows_valid = rows_kept = 0
    try:
        for lo in range(0, batch, num_plants):
            if verbose:
                print(f"collect_gain_dataset_host_batched: round {lo // num_plants + 1}/{batch // num_plants} "
                      f"({num_plants} plants) @ {time.time():.0f}", flush=True)
            for p, (reset_fn, _, _, _) in enumerate(plants):
                reset_fn(x0_np[lo + p])
            u_warm = torch.zeros((num_plants, horizon, control_dim), dtype=dtype, device=dev)
            step_logs = []
            for _ in range(sim_steps):
                x_now = torch.as_tensor(np.stack([read_fn() for (_, read_fn, _, _) in plants]), dtype=dtype,
                                        device=dev)
                u0, u_warm, logs = batched_step(x_now, u_warm)
                step_logs.append(logs)
                u0_np = _host(u0)  # the step's one device-to-host copy
                for p, (_, _, apply_fn, step_fn) in enumerate(plants):
                    apply_fn(u0_np[p])
                    for _ in range(substeps):
                        step_fn()
            # Stack (sim_steps, P, max_iter, ...) and compact on the device.
            stacked = tuple(torch.stack([sl[i] for sl in step_logs]) for i in range(4))
            del step_logs
            x_c, kk_c, n_valid = _compact_valid_rows(*stacked, cap=cap, flatten=False)
            del stacked
            take = int(n_valid)
            rows_valid += take
            if take > cap:
                print(f"collect_gain_dataset_host_batched: round at {lo} produced {take} valid rows > cap {cap}; "
                      f"dropping {take - cap}", flush=True)
                take = cap
            rows_kept += take
            x_host = _host(x_c[:take])
            kk_host = _host(kk_c[:take])
            if writer is not None:
                writer.append({"x_data": x_host, "kk_data": kk_host})
            xs_out.append(x_host)
            kk_out.append(kk_host)
    finally:
        if writer is not None:
            writer.close()
    return GainDataset(
        x_data=np.concatenate(xs_out),
        kk_data=np.concatenate(kk_out),
        stats=CollectStats(rows_kept=rows_kept, rows_valid=rows_valid, rows_dropped=rows_valid - rows_kept),
    )


def save_gain_dataset(path: str, dataset, rows_per_record: int = 1024) -> str:
    """Persist a dataset: ``.qtshard`` as validated shard records (``quattro_tpu_torch.io``), else compressed npz.

    The shard path chunks rows into records, so a partly written collection
    job stays loadable up to its last complete record. ``dataset`` may be a
    :class:`GainDataset` or a :class:`DeviceGainDataset` (copied to the host).
    """
    x_data, kk_data = dataset.x_data, dataset.kk_data
    if path.endswith(".qtshard"):
        from quattro_tpu_torch.io import ShardWriter

        with ShardWriter(path) as w:
            for i in range(0, x_data.shape[0], rows_per_record):
                w.append({
                    "x_data": _host(x_data[i:i + rows_per_record]),
                    "kk_data": _host(kk_data[i:i + rows_per_record]),
                })
    else:
        np.savez_compressed(path, x_data=_host(x_data), kk_data=_host(kk_data))
    return path


class ShardDataset:
    """Lazy row access over ``.qtshard`` dataset files.

    The trainer's streamed-minibatch source: records are decoded on demand
    from the mmap (zero-copy), so a multi-GB dataset never becomes
    host-resident; per step only the gathered minibatch is materialized and
    copied to the device. Rows keep the ``save_gain_dataset`` record layout.
    """

    def __init__(self, paths):
        from quattro_tpu_torch.io import ShardReader

        if isinstance(paths, (str, bytes)):
            paths = [paths]
        self._readers = [ShardReader(str(p)) for p in paths]
        # Row index: cumulative row offset per (reader, record).
        self._records = []  # (reader_idx, record_idx, start_row, num_rows)
        total = 0
        for ri, reader in enumerate(self._readers):
            for rec_i in range(len(reader)):
                rows = int(reader[rec_i]["x_data"].shape[0])
                self._records.append((ri, rec_i, total, rows))
                total += rows
        self._total = total
        self._starts = np.array([r[2] for r in self._records])

    def __len__(self) -> int:
        return self._total

    def gather(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch rows by global index; decodes each touched record once."""
        idx = np.asarray(idx)
        rec_of = np.searchsorted(self._starts, idx, side="right") - 1
        xs = [None] * len(idx)
        ks = [None] * len(idx)
        for rec_id in np.unique(rec_of):
            ri, rec_i, start, _ = self._records[rec_id]
            rec = self._readers[ri][rec_i]
            sel = np.nonzero(rec_of == rec_id)[0]
            local = idx[sel] - start
            x_rows = np.asarray(rec["x_data"])[local]
            k_rows = np.asarray(rec["kk_data"])[local]
            for out_i, xi, ki in zip(sel, x_rows, k_rows):
                xs[out_i] = xi
                ks[out_i] = ki
        return np.stack(xs), np.stack(ks)

    def feature_stats(self, eps: float = 1e-6):
        """Streaming per-feature mean/std over (row, time) for the normalizer: one pass, one record resident."""
        sums = None
        for ri, rec_i, _, _ in self._records:
            rec = self._readers[ri][rec_i]
            x = np.asarray(rec["x_data"], dtype=np.float64)
            k = np.asarray(rec["kk_data"], dtype=np.float64)
            part = (
                x.sum(axis=(0, 1)), (x * x).sum(axis=(0, 1)), x.shape[0] * x.shape[1],
                k.sum(axis=(0, 1)), (k * k).sum(axis=(0, 1)), k.shape[0] * k.shape[1],
            )
            sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
        xs, xs2, xn, ks, ks2, kn = sums
        x_mean = xs / xn
        k_mean = ks / kn
        x_std = np.sqrt(np.maximum(xs2 / xn - x_mean**2, 0.0)) + eps
        k_std = np.sqrt(np.maximum(ks2 / kn - k_mean**2, 0.0)) + eps
        return x_mean, x_std, k_mean, k_std

    def close(self) -> None:
        for r in self._readers:
            r.close()


def load_gain_dataset(paths) -> GainDataset:
    """Load and concatenate dataset files (npz and/or qtshard, mixed)."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    xs, ks = [], []
    for p in paths:
        if str(p).endswith(".qtshard"):
            from quattro_tpu_torch.io import ShardReader

            with ShardReader(str(p)) as r:
                for rec in r:
                    xs.append(np.array(rec["x_data"]))
                    ks.append(np.array(rec["kk_data"]))
        else:
            with np.load(p) as data:
                xs.append(data["x_data"])
                ks.append(data["kk_data"])
    return GainDataset(np.concatenate(xs, axis=0), np.concatenate(ks, axis=0))
