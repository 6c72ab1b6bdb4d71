"""The manifest, every file it names, and the configurations against the program's own factories."""

import json
import re

import pytest
import torch

from bench_cuda import harness
from bench_cuda.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_cuda"] and BENCH["command"][1] == "bench_cuda/run.py"
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(name) for name in names + [w["traffic"] for w in BENCH["workloads"]])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_agree(cell):
    found = harness.Cell(cell)
    e2e = [m["name"] for m in found.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert found.per_layer
    for metric in found.per_layer:
        assert metric["moves"] in e2e, f"{metric['name']} moves {metric['moves']}, which {cell} does not report"
        assert callable(found.reader(metric["name"]).read)
    for part in ("setup", "window", "end_to_end", "counts", "judge_run"):
        assert callable(getattr(found.driver, part))
    assert "u_gap" in found.limits


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_matches_the_program_factory(config):
    """The tables the reference reads are the ones the program's factory builds."""
    import quattro_tpu_torch.control as control

    cfg = json.loads((ROOT / config["file"]).read_text())
    assert config["reduced"] == cfg["reduced"] == []
    prog = cfg["program"]
    ctrl_cost = {}

    def spy(dynamics, running_cost, final_cost, x_ref, horizon, control_dim, ilqr_config, **kwargs):
        ctrl_cost.update(dynamics=dynamics, cost=running_cost, final=final_cost, x_ref=x_ref, horizon=horizon,
                         m=control_dim, config=ilqr_config)
        return None

    original = control.mpc.build_mpc
    control.mpc.build_mpc = spy
    try:
        getattr(control, prog["factory"])(**prog["factory_args"], device="cpu")
    finally:
        control.mpc.build_mpc = original
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    cost = ctrl_cost["cost"]
    assert torch.equal(cost.q_mat, torch.diag(t(cfg["q"]))) and torch.equal(cost.r_mat, torch.diag(t(cfg["r"])))
    assert torch.equal(ctrl_cost["final"].qf_mat, torch.diag(t(cfg["qf"])))
    assert torch.equal(ctrl_cost["x_ref"], t(cfg["x_ref"]))
    assert (cost.barrier_alpha, cost.barrier_beta) == (cfg["barrier_alpha"], cfg["barrier_beta"])
    assert ctrl_cost["horizon"] == cfg["horizon"] and ctrl_cost["m"] == cfg["control_dim"]
    ilqr = ctrl_cost["config"]
    assert (ilqr.tol, ilqr.reg, tuple(ilqr.alphas)) == (cfg["tol"], cfg["reg"], tuple(cfg["alphas"]))
    dyn = ctrl_cost["dynamics"]
    assert (dyn.dt, dyn.method, dyn.plant) == (cfg["dt"], cfg["integration"], cfg["plant"])
    assert dyn.params._asdict() == cfg["params"]
