"""Port parity: the MPC step of both plants, in every mode, against quattro_tpu.

``make_quadrotor_mpc(horizon=16, device="cpu")`` and ``make_cartpole_mpc``
in float64 against the JAX controllers' jitted ``step``, two receding-horizon
steps from the same state (so the warm-start shift is exercised), rtol 1e-8.
While-loop controllers use ``riccati="seq"`` on both sides: the JAX ``"auto"``
resolves to its associative scan, which the port does not have yet. The
megakernel controllers run the JAX Pallas kernel in interpret mode against
the plain form of K3. The hybrid controller uses a small random predictor
carried across with ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.control import make_cartpole_mpc as j_make_cartpole_mpc
from quattro_tpu.control import make_quadrotor_mpc as j_make_quadrotor_mpc
from quattro_tpu import systems as jsystems
from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu.models.gain_predictor import _flatten_params
from quattro_tpu_torch.control import build_mpc, make_cartpole_mpc, make_quadrotor_mpc
from quattro_tpu_torch.models import DataNormalizer, GainPredictor
from quattro_tpu_torch.solver import ILQRConfig

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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cartpole_mpc()


CARTPOLE_CASES = {
    "ilqr": dict(mode="ilqr", riccati="seq"),
    "lqr": dict(mode="lqr"),
    "blend": dict(mode="blend", riccati="seq"),
    "megakernel": dict(solver="megakernel"),
}


@pytest.mark.parametrize("case", list(CARTPOLE_CASES))
@pytest.mark.parametrize("x_start", [[0.15, 0.0, 0.2, 0.0], [0.6, 0.0, 0.8, 0.0]], ids=["near", "mid"])
def test_cartpole_mpc_steps_match_jax(case, x_start):
    """``near`` has ||x|| = 0.25 (blend weight 0: pure LQR control, the solve still
    carries the warm start); ``mid`` has ||x|| = 1 (weight 0.5: the mix)."""
    kwargs = dict(horizon=10, max_iter=3, **CARTPOLE_CASES[case])
    jctrl = j_make_cartpole_mpc(**kwargs)
    tctrl = make_cartpole_mpc(**kwargs, device="cpu", dtype=torch.float64)
    assert (tctrl.horizon, tctrl.control_dim) == (jctrl.horizon, jctrl.control_dim) == (10, 1)

    jdyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
    jx, jstate = jnp.asarray(x_start), jctrl.init_state(dtype=jnp.float64)
    tx, tstate = torch.tensor(x_start, dtype=torch.float64), tctrl.init_state(dtype=torch.float64)
    for _ in range(2):
        ju, jplan, jstate = jctrl.step(jx, jstate)
        tu, tplan, tstate = tctrl.step(tx, tstate)
        for ref, out in ((ju, tu), (jplan, tplan), (jstate.u_warm, tstate.u_warm)):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        assert tplan.shape == (11, 4) and tu.shape == (1,)
        jx = jdyn(jx, ju)
        tx = torch.tensor(np.asarray(jx))


def test_quadrotor_megakernel_mpc_steps_match_jax():
    kwargs = dict(horizon=8, solver="megakernel", max_iter=2)
    jctrl = j_make_quadrotor_mpc(**kwargs)
    tctrl = make_quadrotor_mpc(**kwargs, device="cpu", dtype=torch.float64)
    x = np.zeros(12)
    x[2], x[6] = 0.2, 0.15
    jx, jstate = jnp.asarray(x), jctrl.init_state(dtype=jnp.float64)
    tx, tstate = torch.from_numpy(x), tctrl.init_state(dtype=torch.float64)
    for _ in range(2):
        ju, jplan, jstate = jctrl.step(jx, jstate)
        tu, tplan, tstate = tctrl.step(tx, tstate)
        for ref, out in ((ju, tu), (jplan, tplan), (jstate.u_warm, tstate.u_warm)):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        jx, tx = jplan[1], tplan[1]


def test_blend_cutoffs_like_jax():
    """w <= 0.05 -> pure LQR; w >= 0.95 -> pure primary; between -> the w-weighted mix."""
    make = lambda mode: make_cartpole_mpc(mode=mode, horizon=10, max_iter=3, riccati="seq", device="cpu", dtype=torch.float64)
    blend, ilqr, lqr = make("blend"), make("ilqr"), make("lqr")

    def controls(x):
        x = torch.tensor(x, dtype=torch.float64)
        return [c.step(x, c.init_state(dtype=torch.float64))[0].numpy() for c in (blend, ilqr, lqr)]

    u_b, u_i, u_l = controls([0.02, 0.0, 0.03, 0.0])  # ||e|| = 0.036 -> w = 0
    np.testing.assert_allclose(u_b, u_l, atol=1e-12)
    assert not np.allclose(u_b, u_i, atol=1e-6)
    u_b, u_i, u_l = controls([1.0, 0.0, 1.2, 0.0])  # ||e|| = 1.56 -> w = 1
    np.testing.assert_allclose(u_b, u_i, atol=1e-12)
    assert not np.allclose(u_b, u_l, atol=1e-6)
    u_b, u_i, u_l = controls([0.6, 0.0, 0.8, 0.0])  # ||e|| = 1 -> w = 0.5
    np.testing.assert_allclose(u_b, 0.5 * u_i + 0.5 * u_l, atol=1e-10)


def test_lqr_mode_returns_a_zero_plan_and_keeps_its_state():
    ctrl = make_cartpole_mpc(mode="lqr", device="cpu", dtype=torch.float64)
    state = ctrl.init_state(dtype=torch.float64)
    u, plan, state2 = ctrl.step(torch.tensor([0.1, 0.0, 0.1, 0.0], dtype=torch.float64), state)
    assert plan.shape == (31, 4) and not plan.any() and state2 is state and u.shape == (1,)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: make_cartpole_mpc(mode="hybrid", solver="megakernel", predict_fn=lambda s, p: p, prompt_len=5,
                                   device="cpu"), "megakernel"),
        (lambda: build_mpc(None, None, None, torch.zeros(4), 10, 1, ILQRConfig(adaptive_reg=True),
                           solver="megakernel"), "adaptive_reg"),
        (lambda: build_mpc(None, None, None, torch.zeros(4), 10, 1, ILQRConfig(), mode="lqr"), "lqr_matrices"),
        (lambda: build_mpc(None, None, None, torch.zeros(4), 10, 1, ILQRConfig(), mode="blend"), "lqr_matrices"),
        (lambda: build_mpc(None, None, None, torch.zeros(4), 10, 1, ILQRConfig(), mode="hybrid",
                           predict_fn=lambda s, p: p), "prompt_len"),
    ],
    ids=["megakernel-predictor", "megakernel-adaptive-reg", "lqr-matrices", "blend-matrices", "prompt-len"],
)
def test_build_mpc_refusals_like_jax(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_megakernel_refusals_match_jax():
    """The predictor refusal carries the JAX message; the ``adaptive_reg`` one names
    ``adaptive_reg`` on both sides and gives the port's own reason (reg is a kernel
    argument here; what the kernel lacks is the mu-schedule)."""
    from quattro_tpu.control import build_mpc as j_build_mpc
    from quattro_tpu.solver import ILQRConfig as JILQRConfig

    for jkw, tkw, same_text in (
        (dict(config=JILQRConfig(), predict_fn=lambda s, p: p, prompt_len=5, mode="hybrid"),
         dict(config=ILQRConfig(), predict_fn=lambda s, p: p, prompt_len=5, mode="hybrid"), True),
        (dict(config=JILQRConfig(adaptive_reg=True)), dict(config=ILQRConfig(adaptive_reg=True)), False),
    ):
        with pytest.raises(ValueError) as jerr:
            j_build_mpc(None, None, None, jnp.zeros(4), 10, 1, solver="megakernel", **jkw)
        with pytest.raises(ValueError) as terr:
            build_mpc(None, None, None, torch.zeros(4), 10, 1, solver="megakernel", **tkw)
        if same_text:
            assert str(terr.value) == str(jerr.value)
        else:
            assert "adaptive_reg" in str(terr.value) and "adaptive_reg" in str(jerr.value)


def test_unknown_mode_and_solver_raise_value_error():
    with pytest.raises(ValueError):
        make_quadrotor_mpc(horizon=H, mode="warp", device="cpu")
    with pytest.raises(ValueError):
        make_quadrotor_mpc(horizon=H, solver="warp", device="cpu")
