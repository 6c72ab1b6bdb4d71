"""The one traffic generator: the starts and samples of a run, from ``--seed`` and the mix's parameters.

A traffic mix (``traffic/<name>.json``) is data only: which driver runs it,
the controller's or the solver's settings, how many steps an episode lasts or
how many problems a call holds, and how many answers are judged. The
configuration gives the envelope of start states. This module turns both and
the seed into arrays; every seed gets the same sizes and counts, only other
values.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of the seed for each use, so adding one use moves no other."""
    return np.random.default_rng([int(seed) % (1 << 64), sum(ord(c) << (8 * i) for i, c in enumerate(stream)) % (1 << 63)])


def lhs(gen: np.random.Generator, lower, upper, num: int) -> np.ndarray:
    """Latin-hypercube sample (num, dim): one point per stratum of each axis, strata permuted per axis."""
    lower, upper = np.asarray(lower, dtype=np.float64), np.asarray(upper, dtype=np.float64)
    dim = len(lower)
    strata = np.stack([gen.permutation(num) for _ in range(dim)], axis=1)
    unit = (strata + gen.random((num, dim))) / num
    return lower + unit * (upper - lower)


def starts(config: dict, gen: np.random.Generator, num: int) -> np.ndarray:
    """``num`` start states (num, n), float64: the configuration's envelope on its axes, zero elsewhere."""
    spec = config["start"]
    x = np.zeros((num, config["state_dim"]))
    x[:, spec["axes"]] = lhs(gen, spec["lower"], spec["upper"], num)
    return x
