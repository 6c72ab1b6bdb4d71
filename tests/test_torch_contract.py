"""The kernels' rules in ``ops/contract.py``: ``takes`` against the raising checks and the launches they guard.

On a grid of plants, integrators, dtypes, dimensions and costs, ``takes`` is
False exactly where ``device_plant`` or ``cost_tables`` raises; K5's and K3's
``_launch`` on CPU tensors refuse exactly where ``takes`` or the data's dtype
test fails, before they bind or launch anything; and the batched solve's
``_linquad_applies`` gives K5's answer. Every public kernel entry point raises
``unsupported device`` for a tensor that is neither CUDA nor CPU, and the
rules are read from ``contract`` only: the wrappers keep no copy or alias.
"""

import itertools

import pytest
import torch

from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch import systems as tsystems
from quattro_tpu_torch.ops import _build, blocktridiag, contract, fused_linquad, fused_riccati, fused_rollout
from quattro_tpu_torch.ops import fused_solve, smallchol
from quattro_tpu_torch.parallel import batch as tbatch

BATCH, H = 128, 3  # K5's smallest aligned batch (tile_s 1)
PLANTS = {"quadrotor": (tsystems.QuadrotorField, (12, 4)), "cartpole": (tsystems.CartPoleField, (4, 1))}
DATA = {"float32": (torch.float32, torch.float32), "float64": (torch.float64, torch.float64),
        "float16": (torch.float16, torch.float16), "x64-u32": (torch.float64, torch.float32)}
COSTS = ("quadratic", "lambda-cost", "lambda-final-cost", "tables-wrong-dtype")
GRID = list(itertools.product(PLANTS, ("euler", "rk4"), DATA, ("plant-nm", "wrong-nm"), COSTS))


class Reached(Exception):
    """Raised in place of binding a kernel: the wrapper's checks all passed."""


def costs(kind, n, m, dtype):
    """(running cost, final cost) of ``kind`` at (n, m), tables in ``dtype`` (another one for tables-wrong-dtype)."""
    if kind == "tables-wrong-dtype":
        dtype = torch.float32 if dtype == torch.float64 else torch.float64
    x_ref = torch.zeros(n, dtype=dtype)
    cost = tsolver.make_quadratic_cost(torch.ones(n), torch.full((m,), 0.1), x_ref, barrier_alpha=10.0)
    final_cost = tsolver.make_quadratic_final_cost(10.0 * torch.ones(n), x_ref)
    if kind == "lambda-cost":
        cost = (lambda c: lambda x, u: c(x, u))(cost)
    if kind == "lambda-final-cost":
        final_cost = (lambda c: lambda x: c(x))(final_cost)
    return cost, final_cost


def case(plant, method, data, dims, cost_kind):
    field, (n, m) = PLANTS[plant]
    if dims == "wrong-nm":
        n, m = next(nm for name, (_, nm) in PLANTS.items() if name != plant)
    x_dtype, u_dtype = DATA[data]
    dyn = tsystems.make_discrete(field(), 0.01, method)
    cost, final_cost = costs(cost_kind, n, m, x_dtype)
    return dyn, cost, final_cost, n, m, x_dtype, u_dtype


def raises(fn, *args):
    try:
        fn(*args)
    except (TypeError, ValueError):
        return True
    return False


def refused(launch, *args):
    """True where ``launch`` refuses before binding, False where it reaches the bind; never a launch."""
    _build.reset_launches()
    try:
        launch(*args)
    except Reached:
        return False
    except (TypeError, ValueError):
        return True
    finally:
        assert sum(_build.launches.values()) == 0
    raise AssertionError("the launch neither refused nor reached its bind")


@pytest.fixture
def no_bind(monkeypatch):
    def bind(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(_build, "bind", bind)


@pytest.mark.parametrize("plant, method, data, dims, cost_kind", GRID, ids=["-".join(c) for c in GRID])
def test_takes_agrees_with_the_raising_checks_and_the_launches(no_bind, plant, method, data, dims, cost_kind):
    dyn, cost, final_cost, n, m, x_dtype, u_dtype = case(plant, method, data, dims, cost_kind)
    xs = torch.zeros((BATCH, H + 1, n), dtype=x_dtype)
    us = torch.zeros((BATCH, H, m), dtype=u_dtype)
    data_ok = x_dtype in contract.DTYPES and u_dtype == x_dtype

    for kernel, fcost in ((fused_linquad.KERNEL, None), (fused_solve.KERNEL, final_cost)):
        rules_raise = (raises(contract.device_plant, dyn, kernel, n, m)
                       or raises(contract.cost_tables, kernel, cost, fcost, n, m, xs))
        assert contract.takes(kernel, dyn, cost, fcost, n, m, xs) is not rules_raise

    k5_takes = data_ok and contract.takes(fused_linquad.KERNEL, dyn, cost, None, n, m, xs)
    assert refused(fused_linquad._launch, dyn, cost, xs, us, None, 2) is not k5_takes
    assert tbatch._linquad_applies(dyn, cost, xs[:, 0], us) is k5_takes

    k3_takes = data_ok and contract.takes(fused_solve.KERNEL, dyn, cost, final_cost, n, m, xs)
    assert refused(fused_solve._launch, dyn, cost, final_cost, xs[0], us[0], torch.tensor(1.0), 2, 1e-3, 1e-6,
                   (1.0, 0.5)) is not k3_takes


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def cost_exp(batch, n, m):
    lead = (batch, H) if batch else (H,)
    return tuple(meta(*lead, *tail) for tail in ((n,), (m,), (n, n), (m, m), (m, n)))


def rollout_args(batch):
    lead = (batch,) if batch else ()
    return (meta(*lead, 12), meta(*lead, H + 1, 12), meta(*lead, H, 4), meta(*lead, H, 4), meta(*lead, H, 4, 12),
            meta(6))


DYN = tsystems.make_discrete(tsystems.QuadrotorField(), 0.01, "rk4")
COST, FINAL_COST = costs("quadratic", 12, 4, torch.float32)
PACKED = tuple(meta(2, entries, 1, 128) for entries in (144, 48, 144, 16, 48, 12, 4))
MAT = blocktridiag.BlockTridiagonal(meta(5, 3, 3), meta(4, 3, 3))
ENTRY_POINTS = {
    "K1": lambda: fused_riccati.riccati_backward_fused_single(meta(H, 12, 12), meta(H, 12, 4), cost_exp(0, 12, 4),
                                                              meta(12), meta(12, 12)),
    "K2": lambda: fused_rollout.fused_feedback_rollouts(DYN, *rollout_args(0)),
    "K3": lambda: fused_solve.fused_ilqr_solve_kernel(DYN, COST, FINAL_COST, meta(H + 1, 12), meta(H, 4), meta(),
                                                      2, 1e-3, 1e-6, (1.0,)),
    "K3-from-x0": lambda: fused_solve.fused_ilqr_solve_from_x0(DYN, COST, FINAL_COST, meta(12), meta(H, 4), 2, 1e-3,
                                                               1e-6, (1.0,)),
    "K4-natural": lambda: fused_riccati.riccati_backward_batched_fused(
        meta(BATCH, H, 12, 12), meta(BATCH, H, 12, 4), cost_exp(BATCH, 12, 4), meta(BATCH, 12), meta(BATCH, 12, 12)),
    "K4-packed": lambda: fused_riccati.riccati_backward_batched_fused2d(
        None, None, None, meta(BATCH, 12), meta(BATCH, 12, 12), packed_stage=PACKED, horizon=H - 1),
    "K4-auto": lambda: fused_riccati.riccati_backward_batched_fused_auto(
        meta(BATCH, H, 12, 12), meta(BATCH, H, 12, 4), cost_exp(BATCH, 12, 4), meta(BATCH, 12), meta(BATCH, 12, 12)),
    "K5": lambda: fused_linquad.linquad_batched_fused(DYN, COST, meta(BATCH, H + 1, 12), meta(BATCH, H, 4)),
    "K6": lambda: fused_rollout.fused_feedback_rollouts_batched2d(DYN, *rollout_args(BATCH)),
    "K7": lambda: fused_rollout.fused_feedback_rollouts_batched(DYN, *rollout_args(BATCH)),
    "K8": lambda: smallchol.batched_cholesky_solve_fused(meta(7, 4, 4), meta(7, 4, 2)),
    "K9": lambda: blocktridiag.btd_matvec_fused(MAT, meta(5, 3)),
    "K9-residual": lambda: blocktridiag.kkt_residual(MAT, meta(5, 3), meta(5, 3)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_refuses_a_device_that_is_neither_cuda_nor_cpu(entry):
    _build.reset_launches()
    with pytest.raises(ValueError, match="unsupported device meta"):
        ENTRY_POINTS[entry]()
    assert sum(_build.launches.values()) == 0


MOVED = [(fused_rollout, "DTYPES"), (fused_rollout, "DEVICE_PLANTS"), (fused_rollout, "SUPPORTED_PLANTS"),
         (fused_rollout, "device_plant"), (fused_solve, "cost_tables"), (fused_solve, "SUPPORTED_COSTS"),
         (fused_solve, "DTYPES"), (fused_solve, "device_plant"), (fused_solve, "MAX_N"), (fused_riccati, "MAX_N"),
         (fused_riccati, "MAX_M"), (fused_riccati, "_DTYPES"), (fused_linquad, "DTYPES"),
         (fused_linquad, "device_plant"), (fused_linquad, "cost_tables"), (smallchol, "_DTYPES"),
         (blocktridiag, "_DTYPES")]


@pytest.mark.parametrize("module, name", MOVED, ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n in MOVED])
def test_the_rules_are_importable_from_the_contract_only(module, name):
    assert not hasattr(module, name)
    assert hasattr(contract, name.lstrip("_")) or name == "SUPPORTED_PLANTS"
