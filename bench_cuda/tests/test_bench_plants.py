"""The NumPy plants of the closed loop against RK4 steps worked out by hand."""

import json

import numpy as np
import pytest
import torch

from bench_cuda.reference.plants import FIELDS, HostPlant, rk4_step
from bench_cuda.tests.conftest import ROOT

QUAD = json.loads((ROOT / "bench_cuda" / "configs" / "quadrotor-h50.json").read_text())
CART = json.loads((ROOT / "bench_cuda" / "configs" / "cartpole-h30.json").read_text())


def test_quadrotor_hover_is_an_equilibrium():
    x = np.array(QUAD["x_ref"])
    assert np.array_equal(HostPlant(QUAD).step(x, np.full(4, 9.81 / 4)), x)


def test_quadrotor_free_fall_is_exact_under_rk4():
    # Constant acceleration -g: RK4 integrates it exactly, z - g dt^2 / 2 and v_z - g dt.
    x = np.zeros(12)
    x[2] = 1.0
    nxt = HostPlant(QUAD).step(x, np.zeros(4))
    expect = np.zeros(12)
    expect[2], expect[5] = 1.0 - 0.5 * 9.81 * 0.01**2, -9.81 * 0.01
    np.testing.assert_allclose(nxt, expect, rtol=0, atol=1e-15)


def test_cartpole_step_against_a_hand_written_rk4():
    p = CART["params"]
    m_total = p["m_cart"] + p["m_pole"]

    def field(s, force):
        _, v, th, om = s
        temp = (force + p["m_pole"] * p["length"] * om**2 * np.sin(th)) / m_total
        acc_th = (-p["gravity"] * np.sin(th) + np.cos(th) * temp) / (
            p["length"] * (4.0 / 3.0 - p["m_pole"] * np.cos(th) ** 2 / m_total))
        return np.array([v, temp - p["m_pole"] * p["length"] * acc_th * np.cos(th) / m_total, om, acc_th])

    s, force, dt = np.array([0.1, -0.2, 0.15, 0.3]), 0.7, 0.01
    k1 = field(s, force)
    k2 = field(s + dt / 2 * k1, force)
    k3 = field(s + dt / 2 * k2, force)
    k4 = field(s + dt * k3, force)
    np.testing.assert_allclose(HostPlant(CART).step(s, [force]), s + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4),
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("cfg", [QUAD, CART], ids=["quadrotor", "cartpole"])
def test_numpy_and_torch_paths_agree(cfg):
    gen = np.random.default_rng(3)
    x = 0.2 * gen.standard_normal((5, cfg["state_dim"]))
    u = 1.0 + gen.standard_normal((5, cfg["control_dim"]))
    field = FIELDS[cfg["plant"]]
    host = rk4_step(field, x, u, cfg["params"], cfg["dt"], np)
    dev = rk4_step(field, torch.from_numpy(x), torch.from_numpy(u), cfg["params"], cfg["dt"], torch)
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-14, atol=1e-15)
