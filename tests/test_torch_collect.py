"""Port parity: ``quattro_tpu_torch.training.collect`` against ``quattro_tpu.training.collect``.

``tests/test_training.py``'s fixture: cart-pole RK4 at dt=0.01, H=12, six
initial states (from a numpy seed here), 10 MPC steps, ``ILQRConfig(tol=1e-1,
max_iter=8)``, float64. The port's collection runs its logged batched solve
(the "vmap" backend on the CPU, the kernels' plain forms where a fused
backend is forced), JAX's runs ``vmap(ilqr_solve_with_logs)`` in a scan. Row
counts and stats must be equal and the rows within rtol 1e-8. JAX's random
draws (LHS, domain randomization, the split's permutation) are handed to the
port's transforms, since the bits of ``jax.random`` cannot be reproduced in
torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu import training as jtraining
from quattro_tpu.training import collect as jcollect
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch import training
from quattro_tpu_torch.parallel import batched_ilqr_solve, batched_ilqr_solve_with_logs
from quattro_tpu_torch.training import collect

HORIZON = 12
RTOL = 1e-8
Q, R, QF = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
CONFIG = dict(tol=1e-1, max_iter=8)


def jax_problem(dtype=jnp.float64):
    return (jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4"),
            jsolver.make_quadratic_cost(jnp.asarray(Q, dtype), jnp.asarray(R, dtype), jnp.zeros(4, dtype)),
            jsolver.make_quadratic_final_cost(jnp.asarray(QF, dtype), jnp.zeros(4, dtype)))


def port_problem(dtype=torch.float64):
    t = lambda v: torch.tensor(v, dtype=dtype)
    return (tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4"),
            tsolver.make_quadratic_cost(t(Q), t(R), t([0.0] * 4)),
            tsolver.make_quadratic_final_cost(t(QF), t([0.0] * 4)))


def initial_states(batch=6, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, 4))
    x0[:, 0] = 0.3 * rng.standard_normal(batch)
    x0[:, 2] = 0.3 * rng.standard_normal(batch)
    return x0


def port_collect(x0, **kwargs):
    return training.collect_gain_dataset(*port_problem(), torch.from_numpy(x0), HORIZON, 1, kwargs.pop("steps", 10),
                                         tsolver.ILQRConfig(**kwargs.pop("config", CONFIG)), **kwargs)


def jax_collect(x0, **kwargs):
    return jtraining.collect_gain_dataset(*jax_problem(), jnp.asarray(x0), HORIZON, 1, kwargs.pop("steps", 10),
                                          config=jsolver.ILQRConfig(**kwargs.pop("config", CONFIG)), **kwargs)


def assert_same_rows(got, want, rtol=RTOL):
    got_x, got_kk = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (got.x_data, got.kk_data))
    assert got_x.shape == np.asarray(want.x_data).shape and got_kk.shape == np.asarray(want.kk_data).shape
    for g, w in ((got_x, want.x_data), (got_kk, want.kk_data)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1.0))


@pytest.fixture(scope="module")
def datasets():
    x0 = initial_states()
    return port_collect(x0), jax_collect(x0)


def test_collection_matches_jax(datasets):
    ours, theirs = datasets
    assert ours.x_data.shape[1:] == (HORIZON + 1, 4) and ours.kk_data.shape[1:] == (HORIZON, 5)
    assert ours.x_data.shape[0] > 10
    assert ours.stats[:3] == tuple(theirs.stats)
    assert ours.stats.trips >= 10  # at least one trip per control step
    assert_same_rows(ours, theirs)


@pytest.mark.parametrize("variant", ["chunked", "compacted"])
def test_chunked_and_compacted_collection_match_the_full_batch(datasets, variant):
    """chunk_size=2 splits the sweep, compact_iters=8 gathers the valid rows on the device: the same rows."""
    full, _ = datasets
    kwargs = dict(chunk_size=2) if variant == "chunked" else dict(compact_iters=8)
    other = port_collect(initial_states(), **kwargs)
    np.testing.assert_array_equal(other.x_data, full.x_data)
    np.testing.assert_array_equal(other.kk_data, full.kk_data)
    assert other.stats[:3] == full.stats[:3]


def test_log_budget_picks_a_dividing_chunk(datasets):
    """A budget of two trajectories' logs gives chunks of 2 (6 % 2 == 0) and the same rows."""
    full, _ = datasets
    per_traj = 10 * 8 * ((HORIZON + 1) * 4 + HORIZON * 1 * 5 + 1) * 8
    other = port_collect(initial_states(), log_budget_bytes=2 * per_traj + 1)
    np.testing.assert_array_equal(other.x_data, full.x_data)


def test_compact_cap_beyond_capacity_clamps():
    x0 = np.array([[0.2, 0.0, 0.3, 0.0], [0.1, 0.0, -0.2, 0.0]])
    ds = port_collect(x0, steps=3, config=dict(tol=1e-1, max_iter=4), compact_iters=10, device_resident=True)
    ref = jax_collect(x0, steps=3, config=dict(tol=1e-1, max_iter=4), compact_iters=10, device_resident=True)
    assert ds.stats.rows_dropped == 0 and len(ds) == ds.stats.rows_kept == ref.stats.rows_kept
    assert_same_rows(ds, ref)


def test_compact_cap_drops_and_counts():
    """compact_iters=1 keeps one row per (trajectory, step) and reports the rest as dropped, as JAX does."""
    x0 = initial_states(4, seed=3)
    ds = port_collect(x0, steps=3, compact_iters=1)
    ref = jax_collect(x0, steps=3, compact_iters=1)
    assert ds.stats[:3] == tuple(ref.stats) and ds.stats.rows_dropped > 0
    assert ds.x_data.shape[0] == 4 * 3 * 1
    assert 0.0 < ds.stats.dropped_fraction < 1.0
    assert_same_rows(ds, ref)


def test_device_resident_dataset(datasets):
    """device_resident keeps flat rows (from_flat); to_host, from_host and split on a given permutation."""
    full, jfull = datasets
    dev = port_collect(initial_states(), compact_iters=8, device_resident=True)
    assert isinstance(dev, training.DeviceGainDataset) and dev.x_flat.dim() == 2 and dev.kk_flat.dim() == 2
    assert dev.x_row_shape == (HORIZON + 1, 4) and dev.kk_row_shape == (HORIZON, 5)
    np.testing.assert_array_equal(dev.x_data.numpy(), full.x_data)
    host = dev.to_host()
    np.testing.assert_array_equal(host.x_data, full.x_data)
    np.testing.assert_array_equal(host.kk_data, full.kk_data)
    up = training.DeviceGainDataset.from_host(full, device="cpu")
    np.testing.assert_array_equal(up.kk_data.numpy(), full.kk_data)
    assert up.stats == full.stats

    jdev = jtraining.DeviceGainDataset.from_host(jfull)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(42), len(jdev)))
    jtrain, jtest = jdev.split(0.8, seed=42)
    train, test = training.DeviceGainDataset.from_host(jfull, device="cpu").split(0.8, perm=torch.from_numpy(perm))
    for ours, theirs in ((train, jtrain), (test, jtest)):
        np.testing.assert_array_equal(ours.x_flat.numpy(), np.asarray(theirs.x_flat))
        np.testing.assert_array_equal(ours.kk_flat.numpy(), np.asarray(theirs.kk_flat))
    a, b = dev.split(0.8, seed=7)
    c, _ = dev.split(0.8, seed=7)
    assert len(a) + len(b) == len(dev) and torch.equal(a.x_flat, c.x_flat)

    with pytest.raises(ValueError):
        port_collect(initial_states(), device_resident=True)
    with pytest.raises(ValueError):
        training.DeviceGainDataset(dev.x_flat, dev.kk_flat)


def test_lhs_transform_on_jax_draws():
    """The port's Latin-hypercube transform on JAX's draws gives JAX's samples; the port's own draws keep the
    one-point-per-bin property."""
    lower, upper, num = np.array([-1.0, 0.0, 0.49]), np.array([1.0, 2.0, 0.51]), 64
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 4)
    jitter = np.asarray(jax.random.uniform(keys[0], (3, num)))
    perms = np.stack([np.asarray(jax.random.permutation(keys[d + 1], num)) for d in range(3)])
    ref = np.asarray(jtraining.lhs_initial_states(key, jnp.asarray(lower), jnp.asarray(upper), num))
    got = collect._lhs_from_draws(torch.from_numpy(lower), torch.from_numpy(upper), torch.from_numpy(jitter),
                                  torch.from_numpy(perms))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=1e-15)

    samples = training.lhs_initial_states(torch.Generator().manual_seed(0), torch.from_numpy(lower),
                                          torch.from_numpy(upper), num).numpy()
    assert samples.shape == (num, 3)
    assert (samples >= lower).all() and (samples < upper).all()
    for d in range(3):
        bins = np.floor((samples[:, d] - lower[d]) / (upper[d] - lower[d]) * num)
        assert len(np.unique(bins)) == num


def perturb_draws(key, nominal, num):
    """JAX's draws inside ``perturb_params``: one uniform in [-1, 1) per leaf."""
    leaves = jax.tree_util.tree_leaves(nominal)
    keys = jax.random.split(key, len(leaves))
    return [np.asarray(jax.random.uniform(k, (num,) + np.shape(leaf), minval=-1.0, maxval=1.0))
            for leaf, k in zip(leaves, keys)]


def test_randomized_plant_collection_on_jax_draws():
    """Domain randomization: JAX's draws through the port's transform give JAX's parameters, and the collection
    against those per-trajectory plants gives JAX's rows."""
    jnominal, tnominal = jsystems.CartPoleParams(), tsystems.CartPoleParams()
    jtheta = jtraining.perturb_params(jax.random.PRNGKey(3), jnominal, 0.2, 4)
    draws = perturb_draws(jax.random.PRNGKey(3), jnominal, 4)
    theta = collect._perturb_from_draws(tnominal, 0.2, [torch.from_numpy(d) for d in draws])
    assert type(theta) is tsystems.CartPoleParams
    for ours, theirs in zip(theta, jtheta):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-15)

    def jplant(x, u, p):
        return jsystems.rk4_step(lambda xx, uu: jsystems.cartpole_dynamics(xx, uu, p), x, u, 0.01)

    def tplant(x, u, p):
        return tsystems.rk4_step(lambda xx, uu: tsystems.cartpole_dynamics(xx, uu, p), x, u, 0.01)

    x0 = np.tile([[0.2, 0.0, 0.3, 0.0]], (4, 1))
    cfg = dict(tol=1e-1, max_iter=4)
    ours = port_collect(x0, steps=4, config=cfg, plant_dynamics=tplant, plant_params_batch=theta)
    theirs = jax_collect(x0, steps=4, config=cfg, plant_dynamics=jplant, plant_params_batch=jtheta)
    assert ours.stats[:3] == tuple(theirs.stats)
    assert_same_rows(ours, theirs)
    nominal = port_collect(x0, steps=4, config=cfg)
    assert ours.x_data.shape != nominal.x_data.shape or not np.allclose(ours.x_data, nominal.x_data)
    with pytest.raises(ValueError):
        port_collect(x0, steps=2, config=cfg, plant_params_batch=theta)


def test_perturb_params_draws():
    theta = training.perturb_params(torch.Generator().manual_seed(1), tsystems.CartPoleParams(), 0.2, 500,
                                    device="cpu")
    for leaf, nominal in zip(theta, tsystems.CartPoleParams()):
        factor = leaf.numpy() / nominal
        assert leaf.shape == (500,) and leaf.dtype == torch.get_default_dtype()
        assert (factor >= 0.8).all() and (factor < 1.2).all() and factor.std() > 0.05


def test_compact_valid_rows_matches_jax():
    rng = np.random.default_rng(4)
    shape = (3, 2, 5)
    x, k, big_k = rng.standard_normal(shape + (7, 4)), rng.standard_normal(shape + (6, 2)), rng.standard_normal(
        shape + (6, 2, 4))
    valid = rng.random(shape) > 0.4
    for cap, flatten in ((8, False), (30, True), (100, False)):
        ref = jcollect._compact_valid_rows(*(jnp.asarray(a) for a in (x, k, big_k, valid)), cap=cap, flatten=flatten)
        got = collect._compact_valid_rows(*(torch.from_numpy(a) for a in (x, k, big_k, valid)), cap=cap,
                                          flatten=flatten)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(collect._pack_rows(k[0, 0], big_k[0, 0]), jcollect._pack_rows(k[0, 0], big_k[0, 0]))


def logged_problem(batch=5, seed=6):
    x0 = torch.from_numpy(0.25 * np.random.default_rng(seed).standard_normal((batch, 4)))
    return port_problem(), x0, torch.zeros(batch, HORIZON, 1, dtype=torch.float64)


@pytest.mark.parametrize("backend", ["vmap", "fused"])
@pytest.mark.parametrize("linesearch", ["xla", "fused"])
def test_logged_batched_solve_lanes_match_the_single_solve(backend, linesearch):
    """Each lane of the logged masked loop equals the port's single ``ilqr_solve_with_logs`` (every log field,
    entries past the lane's last iteration zero and invalid); the solve without logs is unchanged."""
    (dyn, cost, fcost), x0, u0 = logged_problem()
    cfg = tsolver.ILQRConfig(tol=1e-2, max_iter=7, linesearch=linesearch)
    sol, logs = batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0, cfg, riccati_backend=backend)
    plain = batched_ilqr_solve(dyn, cost, fcost, x0, u0, cfg, riccati_backend=backend)
    for a, b in zip(sol, plain):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert len(set(sol.iterations.tolist())) > 1  # lanes end at different trips
    for lane in range(x0.shape[0]):
        single_sol, single = tsolver.ilqr_solve_with_logs(dyn, cost, fcost, x0[lane], u0[lane], cfg)
        assert int(sol.iterations[lane]) == single_sol.iterations
        assert torch.equal(logs.valid[lane], single.valid) and torch.equal(logs.found_update[lane], single.found_update)
        for got, want in zip(logs, single):
            want = want.double() if want.dtype != torch.bool else want
            got = got[lane].double() if got.dtype != torch.bool else got[lane]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
        assert not logs.x_seq[lane, single_sol.iterations:].any()


def test_logged_batched_solve_matches_jax_vmap():
    """The logged masked loop against ``vmap(ilqr_solve_with_logs)`` of the JAX package."""
    (dyn, cost, fcost), x0, u0 = logged_problem(seed=8)
    jdyn, jcost, jfcost = jax_problem()
    cfg = dict(tol=1e-2, max_iter=7)
    jsolve = jax.vmap(lambda a, b: jsolver.ilqr_solve_with_logs(jdyn, jcost, jfcost, a, b,
                                                                 jsolver.ILQRConfig(**cfg, batch_hint=5)))
    jsol, jlogs = jsolve(jnp.asarray(x0.numpy()), jnp.asarray(u0.numpy()))
    sol, logs = batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0, tsolver.ILQRConfig(**cfg))
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    for got, want in zip(logs, jlogs):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1.0))


def test_logged_batched_solve_refusals():
    (dyn, cost, fcost), x0, u0 = logged_problem()
    with pytest.raises(ValueError, match="adaptive"):
        batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0, tsolver.ILQRConfig(adaptive_reg=True),
                                     riccati_backend="fused")
    with pytest.raises(ValueError, match="pinned"):
        batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0, tsolver.ILQRConfig(riccati="seq"),
                                     riccati_backend="fused")
    with pytest.raises(ValueError, match="riccati_backend"):
        batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0, riccati_backend="warp")
    sol, logs = batched_ilqr_solve_with_logs(dyn, cost, fcost, x0, u0,
                                             tsolver.ILQRConfig(tol=1e-2, max_iter=4, adaptive_reg=True))
    assert logs.valid.sum(dim=1).tolist() == sol.iterations.tolist()


def _model_plant_adapter(dyn, dtype=np.float32):
    """Host plant adapter driven by the solver's own discrete dynamics."""
    state = {"x": None, "u": None}

    def reset(x0):
        state["x"] = np.asarray(x0, dtype=dtype)

    def read():
        return state["x"]

    def apply(u):
        state["u"] = np.asarray(u, dtype=dtype)

    def step():
        state["x"] = np.asarray(dyn(torch.from_numpy(state["x"]), torch.from_numpy(state["u"])), dtype=dtype)

    return reset, read, apply, step


def _flat_rows(x_data, kk_data):
    return np.concatenate([np.asarray(x_data).reshape(len(x_data), -1),
                           np.asarray(kk_data).reshape(len(kk_data), -1)], axis=1)


def _assert_rows_match(a, b, atol):
    """Each row of ``a`` pairs 1:1 with a distinct row of ``b`` within atol (relative to 1 + |row|)."""
    assert a.shape == b.shape
    used = np.zeros(len(b), dtype=bool)
    for i, row in enumerate(a):
        d = (np.abs(b - row) / (1.0 + np.abs(row))).max(axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        assert d[j] < atol, (i, j, d[j])
        used[j] = True


HOST_X0 = np.array([[0.2, 0.0, 0.2, 0.0], [-0.15, 0.0, -0.25, 0.0],
                    [0.1, 0.0, -0.1, 0.0], [-0.05, 0.0, 0.3, 0.0]], dtype=np.float32)
# tol ~ 0 pins every solve to max_iter iterations, so float noise cannot flip a converge decision.
HOST_CONFIG = dict(tol=1e-12, max_iter=3, riccati="seq")


def test_batched_host_collection_matches_sequential():
    """The lockstep P-plant collector gives the sequential host loop's row set (float64, rtol 1e-9: in float32
    a third iteration from these starts reaches the cost's rounding floor, where an accept is a tie that the
    batched and the single solve, summing in other orders, may break differently)."""
    dyn, cost, fcost = port_problem(torch.float64)
    config = tsolver.ILQRConfig(**HOST_CONFIG)
    x0s = HOST_X0.astype(np.float64)  # float64 states: float64 solves
    seq_parts = []
    for x0 in x0s:
        reset, read, apply, step = _model_plant_adapter(dyn, np.float64)
        seq_parts.append(training.collect_gain_dataset_host(
            reset, read, apply, step, dyn, cost, fcost, x0[None], HORIZON, 1, sim_steps=3, config=config,
            substeps=2, device="cpu"))
    seq_x = np.concatenate([p.x_data for p in seq_parts])
    seq_kk = np.concatenate([p.kk_data for p in seq_parts])
    batched = training.collect_gain_dataset_host_batched(
        [_model_plant_adapter(dyn, np.float64) for _ in range(2)], dyn, cost, fcost, x0s, HORIZON, 1,
        sim_steps=3, config=config, substeps=2, compact_iters=6, device="cpu")
    assert batched.stats.rows_dropped == 0
    assert batched.stats.rows_kept == batched.x_data.shape[0] == seq_x.shape[0] == 4 * 3 * 3
    _assert_rows_match(_flat_rows(batched.x_data, batched.kk_data), _flat_rows(seq_x, seq_kk), atol=1e-9)
    with pytest.raises(ValueError, match="multiple"):  # the lane count must divide the batch
        training.collect_gain_dataset_host_batched(
            [_model_plant_adapter(dyn) for _ in range(3)], dyn, cost, fcost, HOST_X0, HORIZON, 1, sim_steps=2,
            config=config, device="cpu")


def test_host_collection_matches_jax_in_float32():
    """The sequential host loop (float32, both packages' default) on one run: JAX's rows within float32's noise."""
    dyn, cost, fcost = port_problem(torch.float32)
    reset, read, apply, step = _model_plant_adapter(dyn)
    ours = training.collect_gain_dataset_host(reset, read, apply, step, dyn, cost, fcost, HOST_X0[:1], HORIZON, 1,
                                              sim_steps=2, config=tsolver.ILQRConfig(**HOST_CONFIG), substeps=2,
                                              device="cpu")
    jdyn, jcost, jfcost = jax_problem(jnp.float32)
    jreset, jread, japply, jstep = _model_plant_adapter(
        lambda x, u: np.asarray(jdyn(jnp.asarray(x.numpy()), jnp.asarray(u.numpy()))))
    theirs = jtraining.collect_gain_dataset_host(jreset, jread, japply, jstep, jdyn, jcost, jfcost, HOST_X0[:1],
                                                 HORIZON, 1, sim_steps=2, config=jsolver.ILQRConfig(**HOST_CONFIG),
                                                 substeps=2)
    assert ours.x_data.dtype == theirs.x_data.dtype == np.float32
    _assert_rows_match(_flat_rows(ours.x_data, ours.kk_data), _flat_rows(theirs.x_data, theirs.kk_data), atol=1e-4)


def test_batched_host_collection_cap_drop_accounting(tmp_path):
    """A too-small compact cap drops rows and reports an honest fraction; each round is one shard record."""
    dyn, cost, fcost = port_problem(torch.float32)
    x0s = np.array([[0.3, 0.0, 0.3, 0.0], [-0.3, 0.0, -0.3, 0.0]], dtype=np.float32)
    path = str(tmp_path / "rounds.qtshard")
    ds = training.collect_gain_dataset_host_batched(
        [_model_plant_adapter(dyn) for _ in range(2)], dyn, cost, fcost, x0s, HORIZON, 1, sim_steps=4,
        config=tsolver.ILQRConfig(tol=1e-3, max_iter=8, riccati="seq"), compact_iters=1, shard_path=path,
        device="cpu")
    cap = 2 * 4 * 1
    assert ds.x_data.shape[0] == cap
    assert ds.stats.rows_dropped == ds.stats.rows_valid - cap > 0
    assert 0.0 < ds.stats.dropped_fraction < 1.0
    back = training.load_gain_dataset(path)
    np.testing.assert_array_equal(back.x_data, ds.x_data)


def test_batched_host_collection_with_policy():
    """DAgger-style collection: the policy drives the plants while the exact solve labels the rows."""
    dyn, cost, fcost = port_problem(torch.float32)
    applied = []

    def tracking_adapter():
        reset, read, apply, step = _model_plant_adapter(dyn)

        def apply_tracked(u):
            applied.append(np.asarray(u).copy())
            apply(u)

        return reset, read, apply_tracked, step

    def policy(xb, uwb):
        return torch.full((xb.shape[0], 1), 0.123), uwb

    ds = training.collect_gain_dataset_host_batched(
        [tracking_adapter() for _ in range(2)], dyn, cost, fcost, HOST_X0[:2], HORIZON, 1, sim_steps=3,
        config=tsolver.ILQRConfig(tol=1e-12, max_iter=2, riccati="seq"), compact_iters=2, policy=policy,
        device="cpu")
    assert len(applied) == 2 * 3
    assert all(abs(float(u[0]) - 0.123) < 1e-6 for u in applied)
    assert ds.x_data.shape[0] == 2 * 3 * 2
    assert np.isfinite(ds.kk_data).all()


def test_host_collection_writes_one_record_per_run(tmp_path):
    dyn, cost, fcost = port_problem(torch.float32)
    path = str(tmp_path / "runs.qtshard")
    reset, read, apply, step = _model_plant_adapter(dyn)
    ds = training.collect_gain_dataset_host(reset, read, apply, step, dyn, cost, fcost, HOST_X0[:2], HORIZON, 1,
                                            sim_steps=2, config=tsolver.ILQRConfig(**HOST_CONFIG),
                                            shard_path=path, device="cpu")
    from quattro_tpu_torch.io import read_shard

    records = read_shard(path)
    assert len(records) == 2
    np.testing.assert_array_equal(np.concatenate([r["x_data"] for r in records]), ds.x_data)


def test_save_gain_dataset_takes_a_device_dataset(tmp_path, datasets):
    full, _ = datasets
    dev = training.DeviceGainDataset.from_host(full, device="cpu")
    path = training.save_gain_dataset(str(tmp_path / "dev.qtshard"), dev, rows_per_record=16)
    back = jtraining.load_gain_dataset(path)
    np.testing.assert_array_equal(back.x_data, full.x_data)
    sd = training.ShardDataset(path)
    try:
        assert len(sd) == full.x_data.shape[0]
        idx = np.random.default_rng(0).choice(len(sd), size=9, replace=False)
        xg, kg = sd.gather(idx)
        np.testing.assert_array_equal(xg, full.x_data[idx])
        np.testing.assert_array_equal(kg, full.kk_data[idx])
        jsd = jtraining.ShardDataset(path)
        for ours, theirs in zip(sd.feature_stats(), jsd.feature_stats()):
            np.testing.assert_allclose(ours, theirs, rtol=1e-15)
        jsd.close()
    finally:
        sd.close()
