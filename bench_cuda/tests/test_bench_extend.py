"""A later change adds a configuration, a traffic mix, a cell and a per-layer metric as new files only."""

import json

from bench_cuda import harness


def test_new_files_are_found_without_editing_any(bench_copy):
    bench = bench_copy / "bench_cuda"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "quadrotor-h50.json").read_text())
    (bench / "configs" / "quadrotor-h80.json").write_text(json.dumps({**cfg, "horizon": 80}))
    mix = json.loads((bench / "traffic" / "batch-65536.json").read_text())
    (bench / "traffic" / "batch-512.json").write_text(json.dumps({**mix, "batch": 512}))
    (bench / "limits" / "quad-h80-batch512.json").write_text(json.dumps({"u_gap": 1.0}))
    (bench / "metrics" / "calls_per_s.batch.py").write_text(
        "def read(ctx):\n    return ctx.work['calls'] / ctx.trace.window_s\n")
    # The manifest is the one file a new cell changes.
    manifest = json.loads((bench_copy / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "quadrotor-h80", "source": "https://example.org/x",
                                "file": "bench_cuda/configs/quadrotor-h80.json", "reduced": [], "why": "longer"})
    manifest["workloads"].append({"name": "quad-h80-batch512", "config": "quadrotor-h80", "traffic": "batch-512",
                                  "chips": 1, "why": "a longer horizon"})
    for metric in manifest["end_to_end"]:
        if metric["name"] == "solves_per_s":
            metric["workloads"].append("quad-h80-batch512")
    manifest["per_layer"].append({"name": "calls_per_s.batch", "unit": "calls/s", "better": "higher",
                                  "source": "device_trace", "layer": "parallel/batch.py batched solve",
                                  "moves": "solves_per_s", "workloads": ["quad-h80-batch512"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.Cell("quad-h80-batch512", bench_copy)
    assert cell.config["horizon"] == 80 and cell.traffic["batch"] == 512
    assert cell.driver.__file__.endswith("drivers/batch.py")
    assert [m["name"] for m in cell.end_to_end] == ["solves_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s.batch"]
    assert cell.reader("calls_per_s.batch").read(type("Ctx", (), {"work": {"calls": 6},
                                                                  "trace": type("T", (), {"window_s": 2.0})})) == 3.0
    assert all(p.read_bytes() == data for p, data in before.items())
    assert harness.Cell("quad-h50-batch65536", bench_copy).traffic["batch"] == 65536
