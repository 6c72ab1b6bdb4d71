"""Port parity on the paths around K1's dispatch that no other parity test sets, against quattro_tpu.

The bench.py problem (quadrotor RK4 hover, barrier cost) at H=16 with 3
forced iterations in float64, under ``ILQRConfig`` options that change how
the backward pass or the line search is routed: ``chol_solve=False`` (with
the sequential and the associative pass), ``batch_hint=8``,
``linesearch_unroll=4`` and ``adaptive_reg`` with the associative pass. Each
solution is held to JAX's at rtol 1e-8 with the same iteration count (a
review of the port measured at most 1.2e-15 relative here). Then the
cart-pole hybrid MPC with the shipped ``checkpoints/cartpole_gain.npz``
predictor (prompt 5, target 25), ``riccati="seq"``, over 5 closed-loop steps:
u, plan and warm start within 1e-8 of JAX's, normwise (max |difference| over
the largest entry: the predictor's head gains are float32 in both packages
and differ by a float32 ulp, see test_torch_ilqr.py, so single entries near
zero are not held to their own scale).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.control import make_cartpole_mpc as j_make_cartpole_mpc
from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu_torch import solver as tsolver
from quattro_tpu_torch.control import make_cartpole_mpc
from quattro_tpu_torch.models import GainPredictor
from quattro_tpu_torch.ops import _build

from test_torch_ilqr import _close_solution, bench_problem

HYBRID_NORMWISE = 1e-8
CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "cartpole_gain.npz")


@pytest.mark.parametrize(
    "options",
    [
        dict(riccati="seq", chol_solve=False),
        dict(riccati="assoc", chol_solve=False),
        dict(riccati="seq", batch_hint=8),
        dict(riccati="seq", linesearch_unroll=4),
        dict(riccati="assoc", adaptive_reg=True),
    ],
    ids=["no-chol-seq", "no-chol-assoc", "batch-hint-8", "unroll-4", "adaptive-reg-assoc"],
)
def test_ilqr_options_match_jax(options):
    jprob, tprob, _ = bench_problem()
    ref = jsolver.ilqr_solve(*jprob, jsolver.ILQRConfig(tol=0.0, max_iter=3, **options))
    _build.reset_launches()
    out = tsolver.ilqr_solve(*tprob, tsolver.ILQRConfig(tol=0.0, max_iter=3, **options))
    assert sum(_build.launches.values()) == 0  # CPU tensors never reach a kernel
    assert int(out.iterations) == 3
    _close_solution(ref, out)


def test_cartpole_hybrid_mpc_with_the_shipped_predictor_matches_jax():
    jpred = JGainPredictor.load(CHECKPOINT)
    tpred = GainPredictor.load(CHECKPOINT, device="cpu")
    assert (tpred.prompt_len, tpred.target_len) == (jpred.prompt_len, jpred.target_len) == (5, 25)
    kwargs = dict(horizon=30, mode="hybrid", riccati="seq", prompt_len=5)
    jctrl = j_make_cartpole_mpc(predict_fn=jpred.predict_fn(), **kwargs)
    tctrl = make_cartpole_mpc(predict_fn=tpred.predict_fn(), **kwargs, device="cpu", dtype=torch.float64)

    jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
    x_start = [0.15, 0.0, 0.2, 0.0]
    jx, jstate = jnp.asarray(x_start), jctrl.init_state(dtype=jnp.float64)
    tx, tstate = torch.tensor(x_start, dtype=torch.float64), tctrl.init_state(dtype=torch.float64)
    for _ in range(5):
        ju, jplan, jstate = jctrl.step(jx, jstate)
        tu, tplan, tstate = tctrl.step(tx, tstate)
        for ref, out in ((ju, tu), (jplan, tplan), (jstate.u_warm, tstate.u_warm)):
            ref = np.asarray(ref)
            assert np.abs(out.numpy() - ref).max() <= HYBRID_NORMWISE * np.abs(ref).max()
        assert tplan.shape == (31, 4)
        jx = jdyn(jx, ju)
        tx = torch.tensor(np.asarray(jx))
