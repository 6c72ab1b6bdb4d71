"""What the port's CUDA kernels take, stated once: dtypes, sizes, plants and costs.

The kernel wrappers under ``ops/`` check their inputs here before they launch,
and the batched solve asks ``takes`` whether a problem can take K5's route. A
plant is registered in ``DEVICE_PLANTS`` and ``csrc/plants.cuh``, a cost kind in
``SUPPORTED_COSTS`` and ``csrc/costs.cuh``; the kernels read the plant
descriptor of the discrete map (``systems.integrators.DiscreteDynamics``) and
the tables of the cost objects (``solver/costs.py``). Each rule is written once
(``_plant_refusal``, ``_cost_refusal``) and has two forms: the raising one a
wrapper calls and ``takes``, the answer without an exception.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

DTYPES = {torch.float32: 0, torch.float64: 1}  # the dtypes the kernels compute in, by their C entry points' code
MAX_N = 16  # the Riccati step's (K1, K3, K4) largest state and control dimensions: its tiles are sized at compile time
MAX_M = 8
# Plants with device code in csrc/plants.cuh: name -> (kernel's plant id, n, m).
DEVICE_PLANTS = {"quadrotor": (0, 12, 4), "cartpole": (1, 4, 1)}
SUPPORTED_COSTS = ("quadratic", "quadratic_final")


def _plant_refusal(kernel: str, dynamics, n: int, m: int) -> Optional[str]:
    """Why ``kernel`` cannot step ``dynamics`` at (n, m), or None when it can."""
    plant = getattr(dynamics, "plant", None)
    if plant not in DEVICE_PLANTS:
        return (f"{kernel} has device code for the plants {tuple(DEVICE_PLANTS)}; got {plant!r}. Build the dynamics "
                "as make_discrete(QuadrotorField(params), dt, method) or make_discrete(CartPoleField(params), dt, "
                "method), or use the PyTorch forms (linesearch='xla', solver='while').")
    _, plant_n, plant_m = DEVICE_PLANTS[plant]
    if (n, m) != (plant_n, plant_m):
        return f"{kernel}: the {plant} has n={plant_n}, m={plant_m}; got n={n}, m={m}"
    return None


def _tables(cost, final_cost):
    """``(q, r, x_ref)`` of the running cost and, unless ``final_cost`` is None, ``(qf, xf_ref)``."""
    tables = [cost.q_mat, cost.r_mat, cost.x_ref]
    return tables if final_cost is None else tables + [final_cost.qf_mat, final_cost.x_ref]


def _cost_refusal(kernel: str, cost, final_cost, n: int, m: int, like: torch.Tensor) -> Optional[str]:
    """Why ``kernel`` cannot evaluate the costs on ``like``'s dtype and device, or None when it can."""
    kinds = (getattr(cost, "kind", None),) + (() if final_cost is None else (getattr(final_cost, "kind", None),))
    if kinds != SUPPORTED_COSTS[: len(kinds)]:
        return (f"{kernel} has device code for the costs of make_quadratic_cost and make_quadratic_final_cost (kinds "
                f"{SUPPORTED_COSTS}); got kinds {kinds}. Other callables need the PyTorch forms (solver='while', the "
                "solver's derivatives).")
    for t, shape in zip(_tables(cost, final_cost), ((n, n), (m, m), (n,), (n, n), (n,))):
        if tuple(t.shape) != shape or t.dtype != like.dtype or t.device != like.device:
            return (f"{kernel}: cost table expected {shape} {like.dtype} on {like.device}, "
                    f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return None


def takes(kernel: str, dynamics, cost, final_cost, n: int, m: int, like: torch.Tensor) -> bool:
    """False exactly where ``device_plant`` or ``cost_tables`` raises (``final_cost`` None: the running cost alone).

    The data's own dtype and shapes are ``checked``'s.
    """
    return (_plant_refusal(kernel, dynamics, n, m) is None
            and _cost_refusal(kernel, cost, final_cost, n, m, like) is None)


def device_plant(dynamics, kernel: str, n: int, m: int):
    """``(plant id, parameter array, is_rk4, dt)`` of a discrete map for a kernel's C entry point.

    Raises ``ValueError`` for a callable that is not one of the plants with
    device code, or whose dimensions are not the plant's.
    """
    refusal = _plant_refusal(kernel, dynamics, n, m)
    if refusal is not None:
        raise ValueError(refusal)
    values = [float(v) for v in dynamics.params]
    params = (ctypes.c_double * len(values))(*values)
    return DEVICE_PLANTS[dynamics.plant][0], params, int(dynamics.method == "rk4"), float(dynamics.dt)


def cost_tables(kernel: str, cost, final_cost, n: int, m: int, like: torch.Tensor):
    """A kernel's view of the costs: the tables (``_tables``) made contiguous, then alpha, beta.

    Costs not built by ``make_quadratic_cost`` / ``make_quadratic_final_cost``
    (no device code) and tables of another shape, dtype or device than
    ``like``'s raise ``ValueError``.
    """
    refusal = _cost_refusal(kernel, cost, final_cost, n, m, like)
    if refusal is not None:
        raise ValueError(refusal)
    return [t.contiguous() for t in _tables(cost, final_cost)], float(cost.barrier_alpha), float(cost.barrier_beta)


def checked(kernel: str, inputs: Sequence[Optional[torch.Tensor]], shapes: Sequence[tuple], dtype: torch.dtype,
            device: torch.device, names: Optional[Sequence[str]] = None):
    """``inputs`` made contiguous once each has its shape, ``dtype`` and ``device``; None entries pass through.

    A dtype without a code raises ``TypeError``; an input off its shape, dtype
    or device raises ``ValueError``, named by ``names`` where given.
    """
    if dtype not in DTYPES:
        raise TypeError(f"{kernel} takes float32 or float64, got {dtype}")
    for i, (t, shape) in enumerate(zip(inputs, shapes)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype or t.device != device):
            raise ValueError(f"{kernel}:{f' {names[i]}' if names else ''} expected {shape} {dtype} on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return [None if t is None else t.contiguous() for t in inputs]


def on_device(kernel: str, tensor: torch.Tensor, launch, plain, *args):
    """``launch(*args)`` for a CUDA ``tensor``, ``plain(*args)`` for a CPU one; any other device raises ``ValueError``.

    There is no fallback from one to the other: a CUDA input the kernel cannot take raises in ``launch``.
    """
    if tensor.is_cuda:
        return launch(*args)
    if tensor.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"{kernel}: unsupported device {tensor.device}")
