"""The plants of the benchmark's configurations, written once for NumPy and for PyTorch.

The same equations drive the closed loop's host plant (NumPy, float64, outside
the timed step) and the plain reference's rollouts and Jacobians (PyTorch,
under ``torch.func``). ``xp`` is the array module (``numpy`` or ``torch``);
states broadcast over leading axes. The equations are the upstream examples'
(salemon/quattro-transformer-ilqr ``examples/quadrotor`` and
``examples/cartpole``): a 12-state quadrotor with four rotor thrusts in an X
configuration, and a cart-pole with the 4/3 pole-inertia factor. Nothing here
imports the program.
"""

from __future__ import annotations


def _stack(xp, parts):
    return xp.stack(parts, -1)


def quadrotor_field(x, u, p, xp):
    """dx/dt of x = [position, velocity, (roll, pitch, yaw), body rates (p, q, r)], u = four thrusts (N)."""
    roll, pitch, yaw = x[..., 6], x[..., 7], x[..., 8]
    rate_p, rate_q, rate_r = x[..., 9], x[..., 10], x[..., 11]
    u1, u2, u3, u4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    per_mass = (u1 + u2 + u3 + u4) / p["mass"]
    cr, sr = xp.cos(roll), xp.sin(roll)
    cp, sp = xp.cos(pitch), xp.sin(pitch)
    cy, sy = xp.cos(yaw), xp.sin(yaw)
    tp = xp.tan(pitch)
    ix, iy, iz = p["inertia_x"], p["inertia_y"], p["inertia_z"]
    arm, k_yaw = p["arm"], p["k_yaw"]
    return _stack(xp, [
        x[..., 3], x[..., 4], x[..., 5],
        per_mass * (sy * sr + cy * sp * cr),
        per_mass * (cy * sr - sy * sp * cr),
        per_mass * (cp * cr) - p["gravity"],
        rate_p + rate_q * sr * tp + rate_r * cr * tp,
        rate_q * cr - rate_r * sr,
        (rate_q * sr + rate_r * cr) / cp,
        (iy - iz) / ix * rate_q * rate_r + arm * ((u2 + u3) - (u1 + u4)) / ix,
        (iz - ix) / iy * rate_p * rate_r + arm * ((u1 + u2) - (u3 + u4)) / iy,
        (ix - iy) / iz * rate_p * rate_q + k_yaw * (u1 - u2 + u3 - u4) / iz,
    ])


def cartpole_field(x, u, p, xp):
    """dx/dt of x = [position, velocity, angle (0 upright), angular rate], u = [force]."""
    vel, theta, omega = x[..., 1], x[..., 2], x[..., 3]
    m_cart, m_pole, length, g = p["m_cart"], p["m_pole"], p["length"], p["gravity"]
    m_total = m_cart + m_pole
    s, c = xp.sin(theta), xp.cos(theta)
    temp = (u[..., 0] + m_pole * length * omega * omega * s) / m_total
    theta_acc = (-g * s + c * temp) / (length * (4.0 / 3.0 - m_pole * c * c / m_total))
    x_acc = temp - m_pole * length * theta_acc * c / m_total
    return _stack(xp, [vel, x_acc, omega, theta_acc])


FIELDS = {"quadrotor": quadrotor_field, "cartpole": cartpole_field}


def rk4_step(field, x, u, params, dt, xp):
    """One classic Runge-Kutta 4 step with the control held over it."""
    k1 = field(x, u, params, xp)
    k2 = field(x + 0.5 * dt * k1, u, params, xp)
    k3 = field(x + 0.5 * dt * k2, u, params, xp)
    k4 = field(x + dt * k3, u, params, xp)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


class HostPlant:
    """The closed loop's plant on the host: NumPy float64, one RK4 step per control period."""

    def __init__(self, config):
        import numpy

        self._np = numpy
        self._field = FIELDS[config["plant"]]
        self._params = config["params"]
        self._dt = float(config["dt"])

    def step(self, x, u):
        return rk4_step(self._field, x, self._np.asarray(u, dtype=self._np.float64), self._params, self._dt, self._np)
