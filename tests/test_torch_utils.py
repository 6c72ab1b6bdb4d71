"""Port parity: ``quattro_tpu_torch.utils`` against ``quattro_tpu.utils``.

Timing, JSONL metrics, dataset shards across the two packages, the solver
log summary on the same logs, the non-finite guard, ``tree_checksum`` (equal
to JAX's value on the same arrays) and the roofline cost models (equal to
JAX's on a grid of shapes).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.utils import debug as jdebug
from quattro_tpu.utils import metrics as jmetrics
from quattro_tpu.utils import roofline as jroofline
from quattro_tpu.utils import timing as jtiming
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.utils import (
    JsonlLogger,
    PhaseTimer,
    block_nnz_per_sec,
    load_dataset_shards,
    nan_guard,
    save_dataset_shard,
    solver_log_summary,
    tree_checksum,
)
from quattro_tpu_torch.utils import roofline


def test_phase_timer_counts_and_resets():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a", outputs=lambda: [torch.ones(3)]):
            sum(range(1000))
    out = timer.timed("b", lambda: {"x": torch.arange(4.0)})
    assert torch.equal(out["x"], torch.arange(4.0))
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] > 0 and s["a"]["p50_s"] <= s["a"]["p99_s"]
    assert set(s["a"]) == set(jtiming.PhaseTimer().summary().get("a", s["a"]))
    timer.reset()
    assert timer.summary() == {}


def test_jsonl_logger_takes_tensors(tmp_path):
    logger = JsonlLogger(str(tmp_path / "m.jsonl"))
    logger.log({"step": 1, "cost": torch.tensor(2.5), "vec": torch.arange(3), "np": np.float32(1.5)})
    logger.log({"step": 2, "cost": 1.0, "nested": {"a": (torch.tensor([1.0, 2.0]),)}})
    records = logger.read()
    assert len(records) == 2
    assert records[0]["cost"] == 2.5 and records[0]["vec"] == [0, 1, 2] and records[0]["np"] == 1.5
    assert records[1]["nested"] == {"a": [[1.0, 2.0]]}
    # The JAX logger reads the port's file.
    assert jmetrics.JsonlLogger(str(tmp_path / "m.jsonl")).read() == records


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_shards_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    x1, k1 = rng.standard_normal((3, 5, 4)), rng.standard_normal((3, 5, 5)).astype(np.float32)
    x2, k2 = rng.standard_normal((2, 5, 4)), rng.standard_normal((2, 5, 5)).astype(np.float32)
    save = save_dataset_shard if writer == "port" else jmetrics.save_dataset_shard
    load = jmetrics.load_dataset_shards if writer == "port" else load_dataset_shards
    p1 = save(str(tmp_path / "shard.npz"), x1, k1, shard_index=0)
    p2 = save(str(tmp_path / "shard.npz"), torch.from_numpy(x2) if writer == "port" else x2, k2, shard_index=1)
    assert p1.endswith("shard_00000.npz") and p2.endswith("shard_00001.npz")
    x, k = load([p1, p2])
    np.testing.assert_array_equal(x, np.concatenate([x1, x2]))
    np.testing.assert_array_equal(k, np.concatenate([k1, k2]))
    assert k.dtype == np.float32


def test_solver_log_summary_matches_jax():
    """The same cart-pole solve logged by each package (float64): equal summaries within 1e-9."""
    x0, horizon = np.array([0.1, 0.0, 0.2, 0.0]), 20
    q, r, qf = [5.0, 0.1, 10.0, 0.1], [0.001], [50.0, 6.0, 100.0, 0.1]
    jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
    _, jlogs = jsolver.ilqr_solve_with_logs(
        jdyn, jsolver.make_quadratic_cost(jnp.array(q), jnp.array(r), jnp.zeros(4)),
        jsolver.make_quadratic_final_cost(jnp.array(qf), jnp.zeros(4)), jnp.asarray(x0),
        jnp.zeros((horizon, 1)), jsolver.ILQRConfig(tol=1e-1, max_iter=10))
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    tdyn = tsystems.make_discrete(tsystems.CartPoleField(), 0.01, "rk4")
    _, tlogs = tsolver.ilqr_solve_with_logs(
        tdyn, tsolver.make_quadratic_cost(t(q), t(r), t([0.0] * 4)),
        tsolver.make_quadratic_final_cost(t(qf), t([0.0] * 4)), t(x0), torch.zeros(horizon, 1, dtype=torch.float64),
        tsolver.ILQRConfig(tol=1e-1, max_iter=10))
    for valid_only in (True, False):
        ours, theirs = solver_log_summary(tlogs, valid_only), jmetrics.solver_log_summary(jlogs, valid_only)
        assert ours["iterations"] == theirs["iterations"] >= 1
        assert ours["found_update"] == theirs["found_update"]
        for key in ("cost", "new_cost", "alpha"):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-9)
    assert all(a in (1.0, 0.5, 0.25, 0.1, 0.05, 0.01, 0.0) for a in ours["alpha"])


@pytest.mark.parametrize("num_blocks, bands", [(10, 3), (1, 3), (7, 5)])
def test_block_nnz_per_sec_matches_jax(num_blocks, bands):
    assert block_nnz_per_sec(num_blocks, 0.5, bands) == jtiming.block_nnz_per_sec(num_blocks, 0.5, bands)
    assert block_nnz_per_sec(10, 1.0) == 28.0


def test_nan_guard_raises_at_the_first_nonfinite_op():
    seen = []
    with pytest.raises(FloatingPointError, match="log"):
        with nan_guard():
            x = torch.tensor([-1.0, 2.0])
            seen.append(torch.exp(x))
            torch.log(x)  # NaN at index 0
            seen.append("after")
    assert len(seen) == 1
    with pytest.raises(FloatingPointError, match="div"):
        with nan_guard():
            torch.tensor(1.0) / torch.tensor(0.0)
    with nan_guard():  # finite work and integer overflow-free ops pass
        torch.arange(5) * 3 + torch.ones(5).sum()
    # Guard gone afterwards: NaN passes silently again.
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(7),
        "i32": rng.integers(-2**31, 2**31 - 1, (4,), dtype=np.int64).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, (3,)),
        "bool": rng.random(9) > 0.5,
        "i8": np.array([-1, 3, -128, 127], np.int8),
        "scalar": np.array(2.5),
        "empty": np.zeros((0, 3)),
    }


@pytest.mark.parametrize("leaves", [("f32",), ("f64",), ("i32",), ("i64",), ("bool",), ("i8",), ("scalar", "empty"),
                                    tuple(_arrays())])
def test_tree_checksum_equals_jax(leaves):
    arrays = _arrays()
    tree = {k: arrays[k] for k in leaves}
    ours = tree_checksum({k: torch.from_numpy(v) for k, v in tree.items()})
    theirs = jdebug.tree_checksum({k: jnp.asarray(v) for k, v in tree.items()})
    assert int(ours) == int(theirs)
    assert 0 <= int(ours) < 2**32


def test_tree_checksum_sees_one_flipped_bit():
    arrays = _arrays(1)
    base = int(tree_checksum([torch.from_numpy(a) for a in arrays.values()]))
    flipped = arrays["f64"].copy()
    flipped.view(np.uint64)[2] ^= np.uint64(1 << 40)
    changed = dict(arrays, f64=flipped)
    assert int(tree_checksum([torch.from_numpy(a) for a in changed.values()])) != base
    assert int(tree_checksum([])) == 0


GRID = [(h, n, m) for h in (1, 16, 100) for n, m in ((1, 1), (4, 1), (12, 4), (16, 8))]


@pytest.mark.parametrize("horizon, n, m", GRID)
def test_roofline_counts_equal_jax(horizon, n, m):
    assert roofline.riccati_step_flops(n, m) == jroofline.riccati_step_flops(n, m)
    for batch in (1, 8):
        assert roofline.riccati_flops(horizon, n, m, batch) == jroofline.riccati_flops(horizon, n, m, batch)
        for elem in (4, 8):
            for carry in (False, True):
                assert roofline.riccati_bytes(horizon, n, m, batch, elem, carry) == jroofline.riccati_bytes(
                    horizon, n, m, batch, elem, carry)
        for rk4 in (True, False):
            for dyn in (roofline.QUADROTOR_DYN_FLOPS, roofline.CARTPOLE_DYN_FLOPS):
                assert roofline.linearize_flops(horizon, n, m, dyn, rk4, batch) == jroofline.linearize_flops(
                    horizon, n, m, dyn, rk4, batch)
                assert roofline.rollout_flops(horizon, n, m, dyn, 6, rk4, batch) == jroofline.rollout_flops(
                    horizon, n, m, dyn, 6, rk4, batch)
    assert roofline.transformer_flops(horizon + 1, 8 * n, 3, 32 * n, m * (1 + n), n) == jroofline.transformer_flops(
        horizon + 1, 8 * n, 3, 32 * n, m * (1 + n), n)
    assert roofline.QUADROTOR_DYN_FLOPS == jroofline.QUADROTOR_DYN_FLOPS
    assert roofline.CARTPOLE_DYN_FLOPS == jroofline.CARTPOLE_DYN_FLOPS


@pytest.mark.parametrize("flops, nbytes, seconds", [(1e12, 1e9, 1.0), (1e9, 1e9, 1e-3), (5e6, 0.0, 1e-6)])
def test_roofline_report_equals_jax_on_the_same_peak(flops, nbytes, seconds):
    """The port's report on a peak whose float32 rate is JAX's derated one gives JAX's report."""
    jpeak = jroofline.PEAKS["tpu-v5e"]
    peak = roofline.PeakSpec("same", jpeak.matmul_f32_flops, 1.0, jpeak.hbm_bytes)
    ours = roofline.report(flops, nbytes, seconds, peak, "f32")
    theirs = jroofline.report(flops, nbytes, seconds, jpeak, "f32")
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        assert ours[key] == value or (isinstance(value, float) and math.isclose(ours[key], value, rel_tol=1e-15))


def test_h100_peaks_and_dtypes():
    peak = roofline.PEAKS["h100-sxm"]
    assert (peak.f32_flops, peak.f64_flops, peak.hbm_bytes) == (67e12, 34e12, 3.35e12)
    assert peak.flops(torch.float32) == peak.flops("f32") == 67e12
    assert peak.flops(torch.float64) == peak.flops("f64") == 34e12
    with pytest.raises(ValueError):
        peak.flops("bf16")
    rep = roofline.report(34e12, 1.0, 1.0, peak, "f64")
    assert rep["pct_of_peak_flops"] == pytest.approx(100.0) and rep["bound"] == "compute"
    assert list(roofline.PEAKS) == ["h100-sxm"]
