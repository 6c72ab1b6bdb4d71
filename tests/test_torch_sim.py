"""Port parity: ``quattro_tpu_torch.sim`` against ``quattro_tpu.sim``, and the MuJoCo harness under the port.

``tests/test_sim.py``'s five cases run through the port's controllers,
collector and shard dataset (its two long closed loops are marked ``slow``,
each with a shorter case beside it); the two packages' bridges step side by
side on the same controls to the same states (one engine, one XML); and each
package's cart-pole controller, in float64, drives its own bridge for 30 steps
to the same states.
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import jax.numpy as jnp
import torch

from quattro_tpu import sim as jsim
from quattro_tpu.control import make_cartpole_mpc as j_make_cartpole_mpc
from quattro_tpu_torch.control import make_cartpole_mpc, make_quadrotor_mpc
from quattro_tpu_torch.sim import CartPoleBridge, QuadrotorBridge, euler_to_quat, quat_to_rpy
from quattro_tpu_torch.systems import QuadrotorParams

CLOSED_LOOP_ABS = 1e-6


def test_quat_rpy_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        rpy = rng.uniform(-1.0, 1.0, size=3)
        quat = euler_to_quat(*rpy)
        back = quat_to_rpy(*quat)
        np.testing.assert_allclose(back, rpy, atol=1e-10)
        np.testing.assert_array_equal(quat, jsim.euler_to_quat(*rpy))
        assert back == jsim.quat_to_rpy(*quat)


def cartpole_loop(steps, angle=0.3):
    controller = make_cartpole_mpc(horizon=30, device="cpu")
    state = controller.init_state()
    plant = CartPoleBridge()
    plant.reset(position=0.0, angle=angle)
    norms = []
    for _ in range(steps):
        x = plant.read_state()
        u, _, state = controller.step(torch.as_tensor(x, dtype=torch.float32), state)
        plant.apply_control(float(u[0]))
        plant.step()
        norms.append(np.linalg.norm(plant.read_state()))
    return plant.read_state(), norms


@pytest.mark.slow
def test_cartpole_bridge_stabilizes():
    """The solver's model (1 kg / 0.1 kg) stabilizes the mismatched MuJoCo plant through the negated actuator."""
    final, _ = cartpole_loop(500)
    assert np.linalg.norm(final) < 0.1, f"did not stabilize: {final}"


def test_cartpole_bridge_pole_comes_up():
    """The first 100 steps (1 s) of the loop above: the pole angle falls from 0.3 rad below 0.1 and stays finite."""
    final, norms = cartpole_loop(100)
    assert np.isfinite(norms).all()
    assert abs(final[2]) < 0.1, f"pole angle after 1 s: {final}"


def test_quadrotor_bridge_sensor_accessors():
    """IMU readers: the quaternion sensor equals the free joint's, gyro 0 at rest, accel 0 in free fall, ~g in hover."""
    plant = QuadrotorBridge()
    rpy = (0.12, -0.08, 0.3)
    plant.reset(position=(0.0, 0.0, 0.5), rpy=rpy)
    mujoco.mj_forward(plant.model, plant.data)

    sensors = plant.read_sensors()
    assert set(sensors) == {"gyro", "accel", "quat"}
    quat = sensors["quat"] * np.sign(sensors["quat"][0])
    np.testing.assert_allclose(quat, euler_to_quat(*rpy), atol=1e-9)
    np.testing.assert_allclose(sensors["gyro"], 0.0, atol=1e-12)
    assert np.linalg.norm(sensors["accel"]) < 1e-9

    plant.reset(position=(0.0, 0.0, 0.5), rpy=(0.0, 0.0, 0.0))
    plant.apply_thrusts(np.full(4, plant.mass * 9.81 / 4.0))
    for _ in range(5):
        plant.step()
    accel = plant.read_sensors()["accel"]
    assert accel[2] == pytest.approx(9.81, rel=0.05)


def quadrotor_hover(physics_steps):
    plant = QuadrotorBridge()
    params = plant.solver_params()
    controller = make_quadrotor_mpc(horizon=50, quad_params=params, device="cpu")
    state = controller.init_state()
    plant.reset(position=(0.0, 0.0, 0.2), rpy=(0.1, 0.0, 0.0))
    x_ref = np.zeros(12)
    x_ref[2] = 0.5
    u_host = np.zeros(4)
    for step in range(physics_steps):  # MPC every 20 ms
        if step % 20 == 0:
            x = plant.read_state()
            u, _, state = controller.step(torch.as_tensor(x, dtype=torch.float32), state)
            u_host = u.numpy()
            plant.apply_thrusts(u_host)
        plant.step()
    final = plant.read_state()
    return params, final, np.linalg.norm(final - x_ref), u_host


def test_quadrotor_bridge_measured_params():
    """Mass = core + 4 rotors from the MJCF, arm = the planar rotor distance, as the port's ``QuadrotorParams``."""
    params = QuadrotorBridge().solver_params()
    assert isinstance(params, QuadrotorParams)
    assert abs(params.mass - 1.325) < 1e-6
    assert abs(params.arm - float(np.hypot(0.14, 0.18))) < 1e-9
    assert tuple(params) == tuple(jsim.QuadrotorBridge().solver_params())


@pytest.mark.slow
def test_quadrotor_bridge_measured_params_and_hover():
    params, _, err, u_host = quadrotor_hover(2500)  # 2.5 s
    assert err < 0.05, f"did not reach hover: {err}"
    np.testing.assert_allclose(u_host, params.mass * 9.81 / 4.0, rtol=0.05)


def test_quadrotor_bridge_climbs_toward_hover():
    """The first 0.3 s of the loop above: the altitude climbs from 0.2 past 0.4 and the roll falls from 0.1 below
    0.05 (the state error first grows with the climb rate, then falls)."""
    _, final, _, u_host = quadrotor_hover(300)
    assert final[2] > 0.4 and abs(final[6]) < 0.05 and np.isfinite(u_host).all(), final


def test_host_loop_collection_from_mujoco_plant(tmp_path):
    """``collect_gain_dataset_host`` against the MuJoCo cart-pole: training-layout rows from the plant's
    (mismatched) closed-loop states, and the ``.qtshard`` flush round-trips through ``ShardDataset``."""
    from quattro_tpu_torch.solver import ILQRConfig, make_quadratic_cost, make_quadratic_final_cost
    from quattro_tpu_torch.systems import CartPoleField, make_discrete
    from quattro_tpu_torch.training import ShardDataset, collect_gain_dataset_host

    horizon = 12
    dyn = make_discrete(CartPoleField(), 0.01, "rk4")
    cost = make_quadratic_cost(torch.tensor([5.0, 0.1, 10.0, 0.1]), torch.tensor([0.001]), torch.zeros(4))
    fcost = make_quadratic_final_cost(torch.tensor([50.0, 6.0, 100.0, 0.1]), torch.zeros(4))

    plant = CartPoleBridge()
    seen_states = []

    def reset_fn(x0):
        plant.reset(position=float(x0[0]), angle=float(x0[2]))

    def read_fn():
        s = plant.read_state()
        seen_states.append(s.copy())
        return s

    shard = str(tmp_path / "mismatch.qtshard")
    x0s = np.array([[0.1, 0, 0.2, 0], [-0.2, 0, -0.1, 0]], dtype=np.float32)
    dataset = collect_gain_dataset_host(
        reset_fn, read_fn, lambda u: plant.apply_control(float(u[0])), plant.step,
        dyn, cost, fcost, x0s, horizon, 1, sim_steps=6,
        config=ILQRConfig(tol=1e-1, max_iter=4), shard_path=shard, device="cpu",
    )

    assert dataset.x_data.shape[1:] == (horizon + 1, 4)
    assert dataset.kk_data.shape[1:] == (horizon, 5)
    assert dataset.x_data.shape[0] >= 12  # >= 1 iteration per control step

    seen = np.stack(seen_states)
    first_states = dataset.x_data[:, 0, :]
    for row in first_states[:: max(1, len(first_states) // 8)]:
        assert np.min(np.linalg.norm(seen - row, axis=1)) < 1e-5

    sd = ShardDataset(shard)
    try:
        assert len(sd) == dataset.x_data.shape[0]
        xg, kg = sd.gather(np.arange(len(sd)))
        np.testing.assert_allclose(xg, dataset.x_data, rtol=1e-6)
        np.testing.assert_allclose(kg, dataset.kk_data, rtol=1e-6)
    finally:
        sd.close()


def test_bridges_step_like_jax_bridges():
    """The same controls into both packages' bridges give equal states, step after step."""
    rng = np.random.default_rng(3)
    ours, theirs = CartPoleBridge(), jsim.CartPoleBridge()
    for b in (ours, theirs):
        b.reset(position=0.1, angle=-0.2)
    for force in rng.uniform(-20.0, 20.0, 50):
        for b in (ours, theirs):
            b.apply_control(force)
            b.step()
        np.testing.assert_array_equal(ours.read_state(), theirs.read_state())

    ours, theirs = QuadrotorBridge(), jsim.QuadrotorBridge()
    for b in (ours, theirs):
        b.reset(position=(0.1, -0.2, 0.4), rpy=(0.1, -0.05, 0.2))
    for thrusts in rng.uniform(2.0, 4.5, (60, 4)):
        for b in (ours, theirs):
            b.apply_thrusts(thrusts)
            b.step()
        np.testing.assert_array_equal(ours.read_state(), theirs.read_state())
        for key, value in ours.read_sensors().items():
            np.testing.assert_array_equal(value, theirs.read_sensors()[key])
    assert (ours.mass, ours.arm, ours.timestep) == (theirs.mass, theirs.arm, theirs.timestep)


def test_cartpole_closed_loop_matches_jax_on_its_bridge():
    """Each package's cart-pole MPC (float64) on its own bridge, 30 steps from angle 0.2: max |dx| <= 1e-6."""
    jctrl = j_make_cartpole_mpc(horizon=30)
    tctrl = make_cartpole_mpc(horizon=30, device="cpu", dtype=torch.float64)
    jplant, tplant = jsim.CartPoleBridge(), CartPoleBridge()
    for b in (jplant, tplant):
        b.reset(position=0.05, angle=0.2)
    jstate, tstate = jctrl.init_state(dtype=jnp.float64), tctrl.init_state(dtype=torch.float64)
    worst = 0.0
    for _ in range(30):
        ju, _, jstate = jctrl.step(jnp.asarray(jplant.read_state(), dtype=jnp.float64), jstate)
        tu, _, tstate = tctrl.step(torch.as_tensor(tplant.read_state(), dtype=torch.float64), tstate)
        jplant.apply_control(float(np.asarray(ju)[0]))
        tplant.apply_control(float(tu[0]))
        jplant.step()
        tplant.step()
        worst = max(worst, float(np.abs(jplant.read_state() - tplant.read_state()).max()))
    assert worst <= CLOSED_LOOP_ABS, worst
    assert abs(tplant.read_state()[2]) < 0.2
