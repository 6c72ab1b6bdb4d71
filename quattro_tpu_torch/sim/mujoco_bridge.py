"""MuJoCo bridges: plant stepping, state conversion, model-parameter extraction.

Counterpart of ``quattro_tpu/sim/mujoco_bridge.py``, the same engine calls on
the same XML assets:
- ``QuadrotorBridge`` reads the COMPILED model's mass, diagonal inertia and
  mean planar rotor distance ("arm") and returns them as the port's
  ``QuadrotorParams``, so the controller's model is matched to the simulated
  plant.
- State conventions: the 12-D quadrotor state [p, v, rpy, body rates] with y
  and vy sign-flipped, quaternion -> Euler by the aerospace formulas.
- ``CartPoleBridge``: state [qpos0, qvel0, qpos1, qvel1], force negated into
  the actuator.

Host-side numpy by design: the plant steps on the CPU while the controller
runs on its device. ``mujoco`` is imported when a bridge is constructed, so
this module imports where it is not installed.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def euler_to_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Euler (roll, pitch, yaw) -> quaternion [w, x, y, z]."""
    hr, hp, hy = roll / 2.0, pitch / 2.0, yaw / 2.0
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )


def quat_to_rpy(w: float, x: float, y: float, z: float) -> Tuple[float, float, float]:
    """Quaternion [w, x, y, z] -> Euler (roll, pitch, yaw)."""
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = np.arctan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (w * y - z * x)
    pitch = np.sign(sinp) * (np.pi / 2) if abs(sinp) >= 1 else np.arcsin(sinp)

    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = np.arctan2(siny_cosp, cosy_cosp)
    return float(roll), float(pitch), float(yaw)


class CartPoleBridge:
    """Headless MuJoCo cart-pole plant."""

    def __init__(self, xml_path: Optional[str] = None):
        import mujoco

        self._mujoco = mujoco
        path = xml_path or os.path.join(_ASSET_DIR, "cartpole.xml")
        self.model = mujoco.MjModel.from_xml_path(path)
        self.data = mujoco.MjData(self.model)
        self._actuator = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_ACTUATOR, "push")

    @property
    def timestep(self) -> float:
        return float(self.model.opt.timestep)

    def reset(self, position: float = 0.0, angle: float = 0.0) -> None:
        self._mujoco.mj_resetData(self.model, self.data)
        self.data.qpos[0] = position
        self.data.qpos[1] = angle

    def read_state(self) -> np.ndarray:
        """[cart_pos, cart_vel, pole_angle, pole_angular_vel]
        (cartpole_sim.py:143-147 layout)."""
        return np.array(
            [self.data.qpos[0], self.data.qvel[0], self.data.qpos[1], self.data.qvel[1]]
        )

    def apply_control(self, force: float) -> None:
        """Negated into the actuator, preserving the reference convention
        (cartpole_sim.py:153; SURVEY.md §7.6)."""
        self.data.ctrl[self._actuator] = -float(force)

    def step(self) -> None:
        self._mujoco.mj_step(self.model, self.data)


class QuadrotorBridge:
    """Headless MuJoCo quadrotor plant with measured-parameter extraction."""

    def __init__(self, xml_path: Optional[str] = None, body: str = "drone"):
        import mujoco

        self._mujoco = mujoco
        path = xml_path or os.path.join(_ASSET_DIR, "quadrotor.xml")
        self.model = mujoco.MjModel.from_xml_path(path)
        self.data = mujoco.MjData(self.model)

        body_id = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, body)
        self.mass = float(self.model.body_mass[body_id])
        self.inertia_diag = np.array(self.model.body_inertia[body_id])

        # Arm length = mean planar distance of the rotor geoms
        # (quadrotor_wrapper.py:61-73).
        dists = []
        for name in ("rotor1", "rotor2", "rotor3", "rotor4"):
            gid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_GEOM, name)
            pos = self.model.geom_pos[gid]
            dists.append(float(np.hypot(pos[0], pos[1])))
        self.arm = float(np.mean(dists))

        self._thrust_ids = [
            mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_ACTUATOR, f"thrust{i}")
            for i in (1, 2, 3, 4)
        ]

        # IMU sensor addresses (quadrotor_wrapper.py:33-39): gyro / linear
        # accelerometer / body-frame quaternion, resolved once at load.
        # mj_name2id returns -1 for a missing name — indexing sensor_adr[-1]
        # would silently alias the LAST sensor, so a custom XML without the
        # IMU suite gets sensors marked unavailable instead (read_sensors
        # raises; qpos/qvel state reads are unaffected).
        self._sensor_adr = {}
        for key, name, dim in (
            ("gyro", "body_gyro", 3),
            ("accel", "body_linacc", 3),
            ("quat", "body_quat", 4),
        ):
            sid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_SENSOR, name)
            if sid >= 0:
                self._sensor_adr[key] = (int(self.model.sensor_adr[sid]), dim)

    @property
    def timestep(self) -> float:
        return float(self.model.opt.timestep)

    def solver_params(self):
        """Measured-parameter ``QuadrotorParams`` for the solver's model
        (quadrotor_wrapper.py:76-83)."""
        from quattro_tpu_torch.systems.quadrotor import QuadrotorParams

        return QuadrotorParams(
            mass=self.mass,
            inertia_x=float(self.inertia_diag[0]),
            inertia_y=float(self.inertia_diag[1]),
            inertia_z=float(self.inertia_diag[2]),
            arm=self.arm,
        )

    def reset(
        self,
        position=(0.0, 0.0, 0.5),
        rpy=(0.0, 0.0, 0.0),
    ) -> None:
        self._mujoco.mj_resetData(self.model, self.data)
        self.data.qpos[0:3] = position
        self.data.qpos[3:7] = euler_to_quat(*rpy)
        self.data.qvel[:] = 0.0

    def read_state(self) -> np.ndarray:
        """12-D solver state with the reference's y/vy sign flips
        (quadrotor_sim.py:183-194)."""
        state = np.zeros(12)
        state[0:3] = self.data.qpos[0:3]
        state[3:6] = self.data.qvel[0:3]
        state[1] *= -1.0
        state[4] *= -1.0
        state[6:9] = quat_to_rpy(*self.data.qpos[3:7])
        state[9:12] = self.data.qvel[3:6]
        return state

    def read_sensors(self) -> dict:
        """IMU readings {gyro (3,), accel (3,), quat (4,)} from sensordata —
        the sensor-based state-estimation capability of the reference wrapper
        (quadrotor_wrapper.py:107-130). ``read_state`` reads qpos/qvel ground
        truth; this is the noisy-sensor alternative for estimator work.

        Raises ``RuntimeError`` if the loaded model lacks the IMU sensor
        suite (body_gyro/body_linacc/body_quat)."""
        missing = {"gyro", "accel", "quat"} - set(self._sensor_adr)
        if missing:
            raise RuntimeError(
                f"model has no IMU sensors for {sorted(missing)} — add "
                "body_gyro/body_linacc/body_quat sensors to the MJCF or use "
                "read_state() ground truth"
            )
        return {
            key: np.array(self.data.sensordata[adr : adr + dim])
            for key, (adr, dim) in self._sensor_adr.items()
        }

    def apply_thrusts(self, thrusts: np.ndarray) -> None:
        """Per-rotor assignment to the named actuators (quadrotor_sim.py:204-207)."""
        for act_id, value in zip(self._thrust_ids, np.asarray(thrusts).ravel()):
            self.data.ctrl[act_id] = float(value)

    def step(self) -> None:
        self._mujoco.mj_step(self.model, self.data)
