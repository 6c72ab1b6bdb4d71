"""Port parity: the ``examples/*_cuda.py`` programs against the JAX examples they port.

The setups, the cart-pole grid and the MuJoCo plant adapters against
``examples/collect_and_train.py``'s functions on the same inputs (float64
where JAX's setup computes in float64); the quadrotor's Latin hypercube (one
draw per stratum inside the envelope); the DAgger policy, the port's batched
hybrid solve, against JAX's ``vmap`` of the hybrid solve on two lanes; ``.npz``
checkpoints crossing between the packages; small ``main(...)`` runs on the CPU
of each plant, and of the two MuJoCo sims; and ``plot_results_cuda.py
--no-run`` on a synthetic log.
"""

import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu.models import DataNormalizer as JDataNormalizer
from quattro_tpu.models import GainPredictor as JGainPredictor
from quattro_tpu_torch.models import DataNormalizer, GainPredictor

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
CARTPOLE_NPZ = str(ROOT / "checkpoints" / "cartpole_gain.npz")
DAGGER_U_ABS = 1e-8
# Small runs of main(): the collection and training knobs cut to a few rows and a narrow model.
TINY = ["--num-inits", "4", "--sim-steps", "2", "--max-iter", "3", "--d-model", "16", "--nhead", "2",
        "--layers", "1", "--ff", "32", "--horizon", "10", "--prompt-len", "2", "--epochs", "1", "--device", "cpu"]


def load_example(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sys.path.insert(0, str(EXAMPLES))  # the sims import their sibling cartpole_sim_cuda
jex = load_example("collect_and_train")
tex = load_example("collect_and_train_cuda")


@pytest.mark.parametrize("system", ["cartpole", "quadrotor"])
def test_setups_match_jax(system):
    jdyn, jcost, jfcost, jn, jm = getattr(jex, f"{system}_setup")(50)
    tdyn, tcost, tfcost, n, m = getattr(tex, f"{system}_setup")(50, "cpu", torch.float64)
    assert (n, m) == (jn, jm)
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = 0.3 * rng.standard_normal(n)
        u = rng.uniform(0.5, 3.0, m) if system == "quadrotor" else rng.standard_normal(m)
        tx, tu = torch.from_numpy(x), torch.from_numpy(u)
        for ours, theirs in ((tdyn(tx, tu), jdyn(jnp.asarray(x), jnp.asarray(u))),
                             (tcost(tx, tu), jcost(jnp.asarray(x), jnp.asarray(u))),
                             (tfcost(tx), jfcost(jnp.asarray(x)))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("num", [1, 9, 64, 70])
def test_cartpole_grid_matches_jax(num):
    ours = tex.initial_states("cartpole", num, torch.Generator().manual_seed(0), device="cpu")
    theirs = jex.initial_states("cartpole", num, jax.random.PRNGKey(0))
    assert ours.dtype == torch.float32 and ours.shape == (num, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("envelope", ["wide", "reference"])
def test_quadrotor_lhs_one_draw_per_stratum(envelope):
    num = 64
    x0 = tex.initial_states("quadrotor", num, torch.Generator().manual_seed(0), envelope=envelope, device="cpu")
    again = tex.initial_states("quadrotor", num, torch.Generator().manual_seed(0), envelope=envelope, device="cpu")
    assert x0.dtype == torch.float32 and x0.shape == (num, 12) and torch.equal(x0, again)
    lo, hi = (np.asarray(v) for v in tex.QUAD_ENVELOPES[envelope])
    pose = np.concatenate([x0[:, 0:3].numpy(), x0[:, 6:9].numpy()], axis=1).astype(np.float64)
    assert (pose >= lo - 1e-6).all() and (pose <= hi + 1e-6).all()
    strata = np.floor((pose - lo) / (hi - lo) * num).astype(int)
    for d in range(6):
        assert sorted(strata[:, d]) == list(range(num)), f"dimension {d}"
    rest = x0.numpy()[:, [3, 4, 5, 9, 10, 11]]
    assert not rest.any()


def step_adapters(adapters, x0, controls, substeps):
    reset_fn, read_fn, apply_fn, step_fn = adapters
    reset_fn(x0)
    states = [read_fn()]
    for u in controls:
        apply_fn(u)
        for _ in range(substeps):
            step_fn()
        states.append(read_fn())
    return np.stack(states)


@pytest.mark.parametrize("system", ["cartpole", "quadrotor"])
def test_plant_adapters_match_jax(system):
    pytest.importorskip("mujoco")
    rng = np.random.default_rng(4)
    x0 = np.zeros(12 if system == "quadrotor" else 4)
    x0[[0, 2]] = 0.1, (0.4 if system == "quadrotor" else 0.2)
    if system == "quadrotor":
        x0[[1, 6, 7, 8]] = -0.1, 0.1, -0.05, 0.2
    controls = rng.uniform(2.5, 4.0, (5, 4)) if system == "quadrotor" else rng.uniform(-10, 10, (5, 1))
    ours, theirs = tex.mujoco_plant_adapters(system), jex.mujoco_plant_adapters(system)
    assert ours[4] == theirs[4]
    assert (ours[5] is None) == (theirs[5] is None) and (ours[5] is None or tuple(ours[5]) == tuple(theirs[5]))
    np.testing.assert_array_equal(step_adapters(ours[:4], x0, controls, ours[4]),
                                  step_adapters(theirs[:4], x0, controls, theirs[4]))
    (plants, substeps, measured), (jplants, jsubsteps, jmeasured) = (
        tex.mujoco_plant_adapters_batched(system, 2), jex.mujoco_plant_adapters_batched(system, 2))
    assert substeps == jsubsteps and (measured is None or tuple(measured) == tuple(jmeasured))
    for lane in range(2):
        np.testing.assert_array_equal(step_adapters(plants[lane], x0, controls[lane:], substeps),
                                      step_adapters(jplants[lane], x0, controls[lane:], jsubsteps))


class HeldPredictor:
    """A float64 stand-in for a gain predictor, the same arithmetic in either framework: every head gain is
    the first tail gain, scaled by the state error. (The checkpoints' ``predict_fn`` rounds its output to
    float32, so two frameworks' float64 forwards can land one float32 ulp apart and move u by about 1e-6.)"""

    prompt_len = 5

    def predict_fn(self):
        def predict(x_err, prompt):  # leading batch axes pass through
            scale = 1.0 + 0.1 * (x_err[..., :25, :] ** 2).sum(-1, keepdims=True)
            return prompt[..., :1, :] * scale
        return predict


def jax_dagger_policy(jdyn, jcost, jfcost, predictor, tol, n):
    """``examples/collect_and_train.py``'s DAgger policy: ``jax.vmap`` of the RAW hybrid solve."""
    from quattro_tpu.control.mpc import shift_warm_start
    from quattro_tpu.solver import ILQRConfig, hybrid_ilqr_solve

    zeros = jnp.zeros(n, dtype=jnp.float64)
    config = ILQRConfig(tol=tol, max_iter=100)

    def one_policy(x, u):
        return hybrid_ilqr_solve(jdyn, jcost, jfcost, predictor.predict_fn(), predictor.prompt_len, x, u, zeros,
                                 config, state_offset=zeros, exact_fallback=False)

    def policy(xb, uwb):
        sol = jax.vmap(one_policy)(xb, uwb)
        return sol.u_seq[:, 0], jax.vmap(shift_warm_start)(sol.u_seq)

    return policy


DAGGER_X0 = np.array([[0.1, 0.0, 0.2, 0.0], [-0.2, 0.1, -0.15, 0.0]])


def test_dagger_policy_matches_jax_vmap():
    """The port's batched RAW hybrid solve against JAX's ``vmap`` policy on two lanes (float64): the applied
    controls and the shifted warm starts within 1e-8."""
    jdyn, jcost, jfcost, n, m = jex.cartpole_setup(30)
    tdyn, tcost, tfcost, _, _ = tex.cartpole_setup(30, "cpu", torch.float64)
    u_warm = np.zeros((2, 30, m))
    j_u0, j_next = jax_dagger_policy(jdyn, jcost, jfcost, HeldPredictor(), 1e-1, n)(
        jnp.asarray(DAGGER_X0), jnp.asarray(u_warm))
    zeros = torch.zeros(n, dtype=torch.float64)
    policy = tex.make_dagger_policy(tdyn, tcost, tfcost, HeldPredictor(), 1e-1, zeros, zeros)
    u0, u_next = policy(torch.from_numpy(DAGGER_X0), torch.from_numpy(u_warm))
    assert u0.shape == (2, m) and u_next.shape == (2, 30, m)
    assert np.abs(u0.numpy()).max() > 1.0  # the solves moved the controls
    np.testing.assert_allclose(u0.numpy(), np.asarray(j_u0), rtol=0, atol=DAGGER_U_ABS)
    np.testing.assert_allclose(u_next.numpy(), np.asarray(j_next), rtol=0, atol=DAGGER_U_ABS)


def test_dagger_policy_is_the_single_solve_per_lane():
    """With the shipped cart-pole predictor: each lane of the port's policy is the port's own single hybrid
    solve of that lane, within the batched hybrid solve's lane tolerance (u 1e-8): the batch's tail pass is
    K4's law, the single solve's the sequential pass, which round differently."""
    from quattro_tpu_torch.control import shift_warm_start
    from quattro_tpu_torch.solver import ILQRConfig, hybrid_ilqr_solve

    tdyn, tcost, tfcost, n, m = tex.cartpole_setup(30, "cpu", torch.float64)
    pred = GainPredictor.load(CARTPOLE_NPZ, device="cpu")
    zeros = torch.zeros(n, dtype=torch.float64)
    u_warm = torch.zeros((2, 30, m), dtype=torch.float64)
    u0, u_next = tex.make_dagger_policy(tdyn, tcost, tfcost, pred, 1e-1, zeros, zeros)(
        torch.from_numpy(DAGGER_X0), u_warm)
    for lane in range(2):
        sol = hybrid_ilqr_solve(tdyn, tcost, tfcost, pred.predict_fn(), pred.prompt_len,
                                torch.from_numpy(DAGGER_X0[lane]), u_warm[lane], zeros,
                                ILQRConfig(tol=1e-1, max_iter=100), state_offset=zeros, exact_fallback=False)
        np.testing.assert_allclose(u0[lane].numpy(), sol.u_seq[0].numpy(), rtol=0, atol=DAGGER_U_ABS)
        np.testing.assert_allclose(u_next[lane].numpy(), shift_warm_start(sol.u_seq).numpy(), rtol=0,
                                   atol=DAGGER_U_ABS)


def small_hparams():
    return dict(state_dim=4, control_dim=5, prompt_len=3, target_len=7, d_model=16, nhead=2,
                num_decoder_layers=2, dim_feedforward=24, max_seq_len=40)


def normalizer_stats(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(4), rng.uniform(0.5, 2.0, 4), rng.standard_normal(5), rng.uniform(0.5, 2.0, 5))


def predictions(jpred, tpred, seed=0):
    """Both predictors on the same float64 inputs (each model then runs in float64; outputs are float32)."""
    rng = np.random.default_rng(seed)
    x_err, kk = 0.3 * rng.standard_normal((11, 4)), rng.standard_normal((3, 5))
    theirs = np.asarray(jpred.predict_fn()(jnp.asarray(x_err), jnp.asarray(kk)))
    ours = tpred.predict_fn()(torch.from_numpy(x_err), torch.from_numpy(kk)).numpy()
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (7, 5)
    return ours, theirs


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    stats = normalizer_stats(1)
    pred = GainPredictor.create(**small_hparams(), dropout=0.0, generator=torch.Generator().manual_seed(3),
                                normalizer=DataNormalizer(*(torch.tensor(s, dtype=torch.float32) for s in stats)),
                                device="cpu")
    path = str(tmp_path / "port.npz")
    pred.save(path)
    jpred = JGainPredictor.load(path)
    assert jpred.num_params() == pred.num_params()
    np.testing.assert_array_max_ulp(*predictions(jpred, GainPredictor.load(path, device="cpu")), maxulp=4)
    np.testing.assert_array_max_ulp(*predictions(jpred, pred), maxulp=4)


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    stats = normalizer_stats(2)
    jpred = JGainPredictor.create(**small_hparams(), dropout=0.0, rng=jax.random.PRNGKey(5),
                                  normalizer=JDataNormalizer(*(jnp.asarray(s, dtype=jnp.float32) for s in stats)))
    path = str(tmp_path / "jax.npz")
    jpred.save(path)
    pred = GainPredictor.load(path, device="cpu")
    assert pred.num_params() == jpred.num_params()
    np.testing.assert_array_max_ulp(*predictions(jpred, pred), maxulp=4)


@pytest.mark.parametrize("system,plant", [("cartpole", "model"), ("quadrotor", "model"),
                                          ("quadrotor", "randomized"), ("cartpole", "mujoco")])
def test_main_small_run(tmp_path, system, plant):
    """``main`` on the CPU at a tiny depth and width: rows collected, a model trained, a checkpoint both
    packages load."""
    if plant == "mujoco":
        pytest.importorskip("mujoco")
    out = str(tmp_path / "gain.npz")
    extra = ["--device-resident"] if (system, plant) == ("quadrotor", "model") else []
    if system == "quadrotor":
        extra += ["--quad-params", "nominal"]
    summary = tex.main(["--system", system, "--plant", plant, "--out", out] + TINY + extra)
    assert summary["rows"] > 0 and np.isfinite(summary["final_train_loss"])
    if plant != "mujoco":
        assert summary["trips"] >= 2 and summary["rows_valid"] >= summary["rows"]
    assert GainPredictor.load(out, device="cpu").num_params() == summary["params"] == JGainPredictor.load(
        out).num_params()


def test_main_measured_params_fall_back_without_mujoco(tmp_path, monkeypatch, capsys):
    """``--quad-params measured`` where mujoco cannot be loaded: a warning and the nominal vehicle, as in JAX."""
    import quattro_tpu_torch.sim as sim

    def no_mujoco(*args, **kwargs):
        raise ImportError("No module named 'mujoco'")

    monkeypatch.setattr(sim, "QuadrotorBridge", no_mujoco)
    summary = tex.main(["--system", "quadrotor", "--plant", "model", "--epochs", "0", "--out",
                        str(tmp_path / "x.npz")] + TINY[:6] + ["--horizon", "10", "--device", "cpu"])
    assert summary["rows"] > 0
    assert "falling back to nominal" in capsys.readouterr().out


def test_main_refuses_what_jax_refuses():
    with pytest.raises(SystemExit, match="dagger-checkpoint"):
        tex.main(["--system", "cartpole", "--out", "x.npz", "--dagger-checkpoint", CARTPOLE_NPZ])
    with pytest.raises(SystemExit, match="device-resident"):
        tex.main(["--system", "cartpole", "--plant", "mujoco", "--device-resident", "--out", "x.npz"])
    defaults = vars(tex.build_parser().parse_args(["--system", "cartpole", "--out", "x.npz"]))
    assert defaults.pop("device") == "cuda"
    assert defaults["num_inits"] == 64 and defaults["max_iter"] == 8 and defaults["epochs"] == 60


@pytest.mark.parametrize("name,argv", [
    ("cartpole_sim_cuda", ["--steps", "3", "--mode", "hybrid", "--checkpoint", CARTPOLE_NPZ]),
    ("quadrotor_sim_cuda", ["--steps", "41"]),
])
def test_sims_run_on_the_cpu(tmp_path, name, argv):
    pytest.importorskip("mujoco")
    log = str(tmp_path / "log.npz")
    summary = load_example(name).main(argv + ["--device", "cpu", "--log", log])
    assert summary["device"] == "cpu"
    with np.load(log) as data:
        assert np.isfinite(data["states"]).all() and len(data["states"]) == 3


@pytest.mark.parametrize("name", ["cartpole_sim_cuda", "quadrotor_sim_cuda"])
def test_sims_fail_at_once_without_mujoco(monkeypatch, name):
    module = load_example(name)
    monkeypatch.setattr(importlib.util, "find_spec", lambda mod, *a: None if mod == "mujoco" else object())
    with pytest.raises(SystemExit, match="mujoco"):
        module.main(["--steps", "1", "--device", "cpu"])


def test_plot_results_from_a_synthetic_log(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    logs, out = tmp_path / "logs", tmp_path / "figures"
    logs.mkdir()
    rng = np.random.default_rng(0)
    for name in ("cp_ilqr", "cp_hybrid"):
        np.savez(logs / f"{name}.npz", states=rng.standard_normal((30, 4)), controls=rng.standard_normal(30),
                 latencies=np.full(30, 1e-3))
    for name in ("qr_ilqr", "qr_hybrid"):
        np.savez(logs / f"{name}.npz", states=rng.standard_normal((30, 12)), latencies=np.full(30, 1e-3))
    load_example("plot_results_cuda").main(["--no-run", "--tmp", str(logs), "--out", str(out)])
    assert sorted(os.listdir(out)) == ["cartpole_result.png", "quadrotor_result.png"]
    assert all(os.path.getsize(out / f) > 10_000 for f in os.listdir(out))


def notebook_code_cells(path):
    import json

    return ["".join(cell["source"]) for cell in json.loads(path.read_text())["cells"] if cell["cell_type"] == "code"]


def test_training_walkthrough_notebook_runs_on_the_cpu(tmp_path, monkeypatch):
    """``examples/training_walkthrough_cuda.ipynb``'s code cells, in order in one namespace, as a kernel runs
    them with ``WALKTHROUGH_DEVICE=cpu`` (its own sizes: 16 initial states, 10 MPC steps, 5 epochs)."""
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.setenv("WALKTHROUGH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)  # the checkpoint cell writes into the working directory
    monkeypatch.setattr(sys, "path", list(sys.path))
    namespace = {}
    for source in notebook_code_cells(EXAMPLES / "training_walkthrough_cuda.ipynb"):
        exec(compile(source, "training_walkthrough_cuda.ipynb", "exec"), namespace)
    assert namespace["x0s"].device.type == "cpu" and namespace["dataset"].x_data.shape[1:] == (31, 4)
    assert np.isfinite(namespace["result"].train_loss_history).all()
    sols = namespace["sols"]
    assert sols.u_seq.shape == (16, 30, 1) and torch.isfinite(sols.cost).all() and bool(sols.converged.all())
    assert (tmp_path / "cartpole_gain_cuda.npz").exists()
