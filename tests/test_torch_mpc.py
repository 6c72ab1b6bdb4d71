"""Port parity: the quadrotor MPC step, pure and hybrid, against quattro_tpu.

``make_quadrotor_mpc(horizon=16, device="cpu")`` in float64 against the JAX
controller's jitted ``step``, two receding-horizon steps from the same state
(so the warm-start shift is exercised), rtol 1e-8. Both controllers use
``riccati="seq"``: the JAX ``"auto"`` resolves to its associative scan,
which the port does not have yet. The hybrid controller uses a small random
predictor carried across with ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.control import make_quadrotor_mpc as j_make_quadrotor_mpc
from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch.control import build_mpc, make_cartpole_mpc, make_quadrotor_mpc
from quattro_tpu_torch.models import DataNormalizer, GainPredictor

H = 16
WINDOW = 4
RTOL = 1e-8
ATOL = 1e-10


def float32_params(jpred):
    """float32 weights, as made without x64 (x64 makes flax draw target_embedding in float64)."""
    return dataclasses.replace(jpred, params=jax.tree.map(lambda p: p.astype(jnp.float32), jpred.params))


def _predictors():
    jpred = JGainPredictor.create(12, 52, WINDOW, H - WINDOW, d_model=16, nhead=2, num_decoder_layers=1,
                                  dim_feedforward=32, dropout=0.0, max_seq_len=40, rng=jax.random.PRNGKey(7))
    jpred = float32_params(jpred)
    hparams = dict(state_dim=12, control_dim=52, d_model=16, nhead=2, num_decoder_layers=1, dim_feedforward=32,
                   dropout=0.0, max_seq_len=40, target_len=H - WINDOW, prompt_len=WINDOW)
    tpred = GainPredictor.from_flat(hparams, _flatten_params(jpred.params),
                                    DataNormalizer.identity(12, 52, device="cpu"), device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("mode", ["ilqr", "hybrid"])
def test_quadrotor_mpc_steps_match_jax(mode):
    kwargs = dict(horizon=H, mode=mode, riccati="seq", max_iter=10)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if mode == "hybrid":
        jpred, tpred = _predictors()
        jkw.update(predict_fn=jpred.predict_fn(), prompt_len=WINDOW)
        tkw.update(predict_fn=tpred.predict_fn(), prompt_len=WINDOW)
    jctrl = j_make_quadrotor_mpc(**jkw)
    tctrl = make_quadrotor_mpc(**tkw, device="cpu", dtype=torch.float64)

    x = np.zeros(12)
    x[2], x[6] = 0.2, 0.15
    jx, jstate = jnp.asarray(x), jctrl.init_state(dtype=jnp.float64)
    tx, tstate = torch.from_numpy(x), tctrl.init_state(dtype=torch.float64)
    for _ in range(2):
        ju, jplan, jstate = jctrl.step(jx, jstate)
        tu, tplan, tstate = tctrl.step(tx, tstate)
        for ref, out in ((ju, tu), (jplan, tplan), (jstate.u_warm, tstate.u_warm)):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        assert tplan.shape == (H + 1, 12)
        jx, tx = jplan[1], tplan[1]


def test_factories_run_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_quadrotor_mpc(horizon=H)


@pytest.mark.parametrize(
    "make",
    [
        lambda: make_quadrotor_mpc(horizon=H, solver="megakernel", device="cpu"),
        lambda: make_cartpole_mpc(),
        lambda: build_mpc(None, None, None, torch.zeros(12), H, 4, None, mode="lqr"),
        lambda: build_mpc(None, None, None, torch.zeros(12), H, 4, None, mode="blend"),
    ],
    ids=["megakernel", "cartpole", "lqr", "blend"],
)
def test_unported_modes_name_their_roadmap_item(make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()


def test_unknown_mode_and_solver_raise_value_error():
    with pytest.raises(ValueError):
        make_quadrotor_mpc(horizon=H, mode="warp", device="cpu")
    with pytest.raises(ValueError):
        make_quadrotor_mpc(horizon=H, solver="warp", device="cpu")
