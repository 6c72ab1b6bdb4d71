"""The batch cell's prepared calls: more of them leave the first ones as they were.

The driver draws each call's starts and judged lanes from one stream of the
seed each, call after call, so raising ``max_calls_per_second`` only appends
calls. Set-up runs at the cell's own batch and window length, with the warm-up
solve left out.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_cuda import harness

BATCH_CELL = "quad-h50-batch65536"


def _prepared(rate, seed):
    cell = harness.Cell(BATCH_CELL)
    cell.driver._call = lambda st, x0: None  # no warm-up solve: only the inputs are compared
    seconds = harness.manifest()["run_seconds"]
    run = SimpleNamespace(config=cell.config, traffic={**cell.traffic, "max_calls_per_second": rate}, seed=seed,
                          seconds=seconds, device=torch.device("cpu"), variant="program")
    st = cell.driver.setup(run)
    return st.max_calls, st.starts, st.judged


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_more_prepared_calls_leave_the_first_ones_as_they_were(seed):
    assert harness.Cell(BATCH_CELL).traffic["max_calls_per_second"] == 10
    few, few_starts, few_judged = _prepared(3, seed)
    many, many_starts, many_judged = _prepared(10, seed)
    assert (few, many) == (32, 102)
    assert many_starts.shape == (102, 65536, 12) and many_starts.dtype == np.float32
    assert np.array_equal(many_starts[:32], few_starts)
    assert many_judged[:32] == few_judged
    assert not np.array_equal(many_starts[32], many_starts[31])
