"""Port parity: meshes, collectives, ``sharded_ilqr_solve`` and the trainer's ``mesh=`` on virtual CPU meshes.

A virtual mesh names the CPU several times (JAX's tests run on 8 virtual
CPU devices, ``tests/conftest.py``). The sharded solve is held to the port's
``batched_ilqr_solve`` lane for lane (iterations and flags equal, cost rtol
1e-9, u atol 1e-8, the tolerances of ``tests/test_parallel.py``) and to
JAX's ``batched_ilqr_solve`` on the same inputs (``tests/test_torch_batch.py``'s
tolerances); the data-parallel trainer to ``mesh=None`` (losses rtol 1e-9
with the dropout masks shared). Float64, inputs from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import parallel as jparallel
from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch import training
from quattro_tpu_torch.models import GainPredictor
from quattro_tpu_torch.parallel import (
    batched_ilqr_solve, collectives, distributed, make_mesh, sharded_ilqr_solve, traj_sharding,
)
from quattro_tpu_torch.parallel.mesh import GlobalArray, Mesh, assemble, shard


def cpu_mesh(shape, names=("traj", "horizon")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def test_mesh_construction():
    """``tests/test_parallel.py``'s cases on 8 virtual CPU devices."""
    mesh = cpu_mesh((8, 1))
    assert mesh.shape == {"traj": 8, "horizon": 1}
    assert cpu_mesh((2, 4)).shape == {"traj": 2, "horizon": 4}
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=["cpu"] * 8)
    assert make_mesh(devices=["cpu"] * 4).shape == {"traj": 4, "horizon": 1}
    assert traj_sharding(mesh) == ("traj",)
    with pytest.raises(ValueError, match="no axis"):
        traj_sharding(mesh, "batch")


def test_default_mesh_needs_a_card(monkeypatch):
    """The default mesh is every CUDA device; without a card it raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2,), ("traj",), devices=["cuda:0", "cuda:0"])


def test_shard_and_assemble_round_trip():
    """Blocks cut along a (traj, horizon) spec, and a replicated axis the spec leaves out."""
    mesh = cpu_mesh((2, 4))
    x = torch.arange(4 * 8 * 3, dtype=torch.float64).reshape(4, 8, 3)
    shards = shard(x, mesh, ("traj", "horizon"), mesh.coords(("traj", "horizon")))
    assert len(shards) == 8 and shards[(1, 2)].shape == (2, 2, 3)
    torch.testing.assert_close(shards[(1, 2)], x[2:4, 4:6], rtol=0, atol=0)
    assert torch.equal(assemble(shards, mesh, ("traj", "horizon"), "cpu"), x)
    rows = shard(x, mesh, "horizon", mesh.coords(("horizon",)))
    assert sorted(rows) == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert torch.equal(assemble(rows, mesh, ("horizon",), "cpu"), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard(x, mesh, (None, None, "horizon"), mesh.coords(("horizon",)))


def test_ppermute_and_psum_follow_lax():
    """``ppermute``: a shard no pair sends to receives zeros; ``psum``: each group along the axis sums alone;
    the hop counter counts the one round and its bytes."""
    mesh = cpu_mesh((2, 4))
    comm = collectives.AxisComm(mesh, "horizon", mesh.coords(("traj", "horizon")))
    values = {c: (torch.full((3,), 10.0 * c[0] + c[1], dtype=torch.float64), torch.tensor(float(c[1]), dtype=torch.float64))
              for c in comm.local}
    collectives.hops.reset()
    moved = comm.ppermute(values, [(0, 1), (1, 2), (2, 3)])
    assert collectives.hops.rounds == 1 and collectives.hops.bytes_per_hop == [4 * 8]
    for (t, h), (vec, scalar) in moved.items():
        expect = 0.0 if h == 0 else 10.0 * t + h - 1
        assert torch.equal(vec, torch.full((3,), expect, dtype=torch.float64)) and float(scalar) == (0.0 if h == 0 else h - 1)
    sums = comm.psum(values)
    for (t, h), (vec, scalar) in sums.items():
        assert torch.equal(vec, torch.full((3,), 40.0 * t + 6.0, dtype=torch.float64)) and float(scalar) == 6.0
    assert [comm.axis_index(c) for c in comm.local[:4]] == [0, 1, 2, 3]


def cartpole(x0s, horizon):
    """(jax args, torch args): dyn, cost, fcost, x0 batch, zero controls (``tests/test_parallel.py``'s problem)."""
    q, r, qf = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
    u0s = np.zeros((x0s.shape[0], horizon, 1))
    j = (jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4"),
         jsolver.make_quadratic_cost(jnp.asarray(q), jnp.asarray(r), jnp.zeros(4)),
         jsolver.make_quadratic_final_cost(jnp.asarray(qf), jnp.zeros(4)), jnp.asarray(x0s), jnp.asarray(u0s))
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    tp = (tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
          tsolver.make_quadratic_cost(t(q), t(r), t(np.zeros(4))),
          tsolver.make_quadratic_final_cost(t(qf), t(np.zeros(4))), t(x0s), t(u0s))
    return j, tp


def assert_lanes_equal(got, ref, cost_rtol=1e-9, u_atol=1e-8):
    np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(ref.iterations))
    np.testing.assert_array_equal(np.asarray(got.converged), np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost), rtol=cost_rtol)
    np.testing.assert_allclose(np.asarray(got.u_seq), np.asarray(ref.u_seq), rtol=0, atol=u_atol)
    np.testing.assert_allclose(np.asarray(got.x_seq), np.asarray(ref.x_seq), rtol=0, atol=u_atol)


@pytest.fixture(scope="module")
def traj_problem():
    """``tests/test_parallel.py::test_sharded_traj_solve_matches_batched``'s problem, x0 from a numpy seed."""
    x0s = 0.3 * np.random.default_rng(0).standard_normal((16, 4))
    return cartpole(x0s, 30), tsolver.ILQRConfig(tol=1e-1, max_iter=20)


def test_sharded_solve_equals_batched_lane_for_lane(traj_problem):
    (_, problem), cfg = traj_problem
    mesh = cpu_mesh((8, 1))
    sharded = sharded_ilqr_solve(*problem, mesh, cfg)
    plain = batched_ilqr_solve(*problem, cfg)
    assert_lanes_equal(sharded, plain)
    assert sharded.iterations.dtype == torch.int32 and sharded.converged.dtype == torch.bool
    for got, ref in zip(sharded, plain):
        assert got.shape == ref.shape
    # Each shard iterates until its own lanes are done: a shard's trips are its own lanes' most.
    shard_iters = sharded.iterations.reshape(8, 2).max(dim=1).values
    assert int(shard_iters.min()) <= int(sharded.iterations.max())


def test_sharded_solve_equals_jax_batched(traj_problem):
    """The same inputs through JAX's ``batched_ilqr_solve`` (iterations and flags equal, x, u and cost rtol 1e-8)."""
    (jproblem, problem), _ = traj_problem
    jcfg = jsolver.ILQRConfig(tol=1e-1, max_iter=20)
    ref = jparallel.batched_ilqr_solve(*jproblem, jcfg)
    sharded = sharded_ilqr_solve(*problem, cpu_mesh((8, 1)), tsolver.ILQRConfig(tol=1e-1, max_iter=20))
    np.testing.assert_array_equal(sharded.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(sharded.converged.numpy(), np.asarray(ref.converged))
    for name in ("x_seq", "u_seq", "cost"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(sharded, name).numpy(), r, rtol=1e-8, atol=1e-8 * float(np.abs(r).max()))


def test_sharded_solve_takes_global_arrays_and_refuses_an_uneven_batch(traj_problem):
    """``host_local_to_global`` in one process holds every shard; the solve then returns ``GlobalArray``s."""
    (_, problem), cfg = traj_problem
    dyn, cost, fcost, x0s, u0s = problem
    mesh = cpu_mesh((4,), ("traj",))
    gx, gu = (distributed.host_local_to_global(mesh, "traj", v) for v in (x0s, u0s))
    assert isinstance(gx, GlobalArray) and gx.shape == (16, 4) and len(gx.shards) == 4
    sol = sharded_ilqr_solve(dyn, cost, fcost, gx, gu, mesh, cfg)
    assert isinstance(sol.cost, GlobalArray) and sol.u_seq.shape == (16, 30, 1)
    plain = batched_ilqr_solve(*problem, cfg)
    host = type(plain)(*(distributed.global_to_host_local(mesh, "traj", f) for f in sol))
    assert_lanes_equal(host, plain)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_ilqr_solve(dyn, cost, fcost, x0s[:10], u0s[:10], mesh, cfg)


def test_sharded_solve_refuses_several_devices_in_one_process(traj_problem):
    """The problem's functions keep their tensors on one device, so one process's shards must share it."""
    (_, problem), cfg = traj_problem
    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="one process per device"):
        sharded_ilqr_solve(*problem, Mesh(grid, ("traj",)), cfg)


@pytest.fixture(scope="module")
def gain_dataset():
    """``tests/test_torch_train.py``'s dataset (the cart-pole collection, float64)."""
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    rng = np.random.default_rng(0)
    x0 = np.zeros((6, 4))
    x0[:, 0], x0[:, 2] = 0.3 * rng.standard_normal(6), 0.3 * rng.standard_normal(6)
    return training.collect_gain_dataset(
        tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
        tsolver.make_quadratic_cost(t([5.0, 0.1, 10.0, 0.1]), t([0.001]), t([0.0] * 4)),
        tsolver.make_quadratic_final_cost(t([50.0, 6.0, 100.0, 0.1]), t([0.0] * 4)),
        torch.from_numpy(x0), 12, 1, 10, tsolver.ILQRConfig(tol=1e-1, max_iter=8))


def small_predictor(dropout):
    """A float64 predictor (training runs in the parameters' dtype)."""
    predictor = GainPredictor.create(4, 5, 3, 9, d_model=32, nhead=4, num_decoder_layers=2, dim_feedforward=64,
                                     dropout=dropout, max_seq_len=64, generator=torch.Generator().manual_seed(0),
                                     device="cpu")
    predictor.module.double()
    return predictor


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_data_parallel_steps_equal_unsharded(gain_dataset, shards, dropout):
    """5 Adam steps (one whole-dataset batch per epoch) with ``mesh=`` against ``mesh=None``: losses rtol 1e-9,
    the trained parameters rtol 1e-9 / atol 1e-8 (``tests/test_torch_train.py``'s bars); with dropout on, the
    masks of the two runs are the same draws."""
    rows = gain_dataset.x_data.shape[0]
    rows -= rows % 4
    data = training.GainDataset(gain_dataset.x_data[:rows], gain_dataset.kk_data[:rows])
    config = training.TrainConfig(num_epochs=5, batch_size=rows, learning_rate=3e-3, lr_schedule="cosine")
    plain = training.train_gain_predictor(small_predictor(dropout), data, None, config)
    meshed = training.train_gain_predictor(small_predictor(dropout), data, None, config,
                                           mesh=make_mesh((shards,), ("data",), devices=["cpu"] * shards))
    assert len(meshed.train_loss_history) == 5
    np.testing.assert_allclose(meshed.train_loss_history, plain.train_loss_history, rtol=1e-9)
    ours = meshed.predictor.module.state_dict()
    for name, value in plain.predictor.module.state_dict().items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=1e-9, atol=1e-8)
