"""The harness finds its parts by name: a new cell and a new metric are
new files and a line each in ``BENCHMARK.json``, nothing more.  And
what the readers take from a trace."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.trace import Trace

DUMMY_METRIC = '''"""A dummy per-layer metric."""


def read(run):
    return 42.0
'''


def add_files(root):
    wl = harness.workload("fastdepth.batch-b512", root)
    with open(os.path.join(root, "perfbench", "workloads", "dummy.cell.json"), "w") as f:
        json.dump(dict(wl, batch=2), f)
    with open(os.path.join(root, "perfbench", "metrics", "dummy_metric.x.py"), "w") as f:
        f.write(DUMMY_METRIC)
    b = harness.bench(root)
    b["workloads"].append({"name": "dummy.cell", "config": "fastdepth-pruned-224",
                           "traffic": "dummy", "chips": 1, "why": "a test"})
    next(m for m in b["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "dummy.cell")
    b["per_layer"].append({"name": "dummy_metric.x", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "model step",
                           "moves": "frames_per_s", "workloads": ["dummy.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


def test_a_new_cell_and_metric_are_new_files_only(root):
    before = {p for p in os.listdir(os.path.join(root, "perfbench", "workloads"))}
    add_files(root)
    assert "dummy.cell" in harness.cells(root)
    assert harness.workload("dummy.cell", root)["batch"] == 2
    wanted = harness.metrics_of("dummy.cell", root)
    assert [m["name"] for m in wanted["per_layer"]] == ["dummy_metric.x"]
    assert {m["name"] for m in wanted["end_to_end"]} == {"frames_per_s", "setup_s"}
    assert harness.module("metrics", "dummy_metric.x", root).read(None) == 42.0
    after = {p for p in os.listdir(os.path.join(root, "perfbench", "workloads"))}
    assert after - before == {"dummy.cell.json"}


def test_the_dummy_cell_runs_and_reports_its_metric(root, monkeypatch):
    from perfbench import run

    add_files(root)
    monkeypatch.setattr("perfbench.trace.traced", fake_traced)
    r = run.measure("dummy.cell", 2 ** 31 + 2, 0.3, True, root=root, device="cpu",
                    check_device=False)
    assert r["correct"] and r["metrics"] == {"dummy_metric.x": {"value": 42.0, "unit": "%"}}


def test_every_cell_and_metric_has_its_files():
    b = harness.bench()
    for cell in harness.cells():
        wl = harness.workload(cell)
        cfg = harness.config(wl["config"])
        assert cfg["name"] == wl["config"]
        harness.module("entries", wl["entry"])
        harness.module("reference", cfg["family"])
        harness.module("work", cfg["family"])
        assert set(wl["limits"])
    for m in b["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)
    for c in b["configs"]:
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))["name"] == c["name"]


def test_benchmark_json_keeps_to_the_contract():
    b = harness.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    cells = {w["name"] for w in b["workloads"]}
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        wanted = harness.metrics_of(cell)
        assert len(wanted["end_to_end"]) >= 2 and wanted["per_layer"]


# the metrics whose lists named fastdepth.batch-b128 first, as
# fastdepth.batch-b512 replaced it
FLAGSHIP_METRICS = ("frames_per_s", "device_idle_pct.throughput", "mfu_pct",
                    "decoder_roofline_pct", "encoder_mfu_pct", "metrics_us_per_frame",
                    "decoder_roofline_pct.spans", "launch_idle_pct.throughput")


def test_the_b512_flagship_cell_stands_where_the_b128_one_stood():
    from perfbench.tests.conftest import RETIRED_CELL, SUCCESSOR

    b = harness.bench()
    first = b["workloads"][0]
    assert (first["name"], first["config"], first["traffic"], first["chips"]) == (
        SUCCESSOR, "fastdepth-pruned-224", "batch-b512", 1)
    wl = harness.workload(SUCCESSOR)
    assert (wl["entry"], wl["batch"], wl["dtype"], wl["impl"], wl["ring"]) == (
        "batch", 512, "bfloat16", "auto", 8)
    assert (wl["warmup_steps"], wl["sample_steps"], wl["sample_from"], wl["trace_seconds"]) == (
        3, 3, 64, 2)
    assert set(wl["limits"]) == {"pred_rel_l2", "metric_gap"}
    for m in b["end_to_end"] + b["per_layer"]:
        listed = m.get("workloads", [])
        assert (SUCCESSOR in listed) == (m["name"] in FLAGSHIP_METRICS)
        assert SUCCESSOR not in listed or listed.index(SUCCESSOR) == 0
        assert RETIRED_CELL not in listed
    assert RETIRED_CELL not in harness.cells()
    folder = os.path.join(harness.ROOT, "perfbench", "workloads")
    for name in os.listdir(folder):
        with open(os.path.join(folder, name)) as f:
            assert RETIRED_CELL not in f.read()


def fake_traced(python=False):
    import contextlib

    @contextlib.contextmanager
    def cm():
        out = {}
        yield out
        out["trace"] = Trace(window_s=1.0)
    return cm()


def chrome(events):
    return Trace.from_chrome(events, window_s=0.01)


EVENTS = [
    {"ph": "X", "cat": "python_function", "name": "a/ops/cuda/fused_decoder.py(253): "
     "fused_decoder_stage", "ts": 100.0, "dur": 50.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120.0, "dur": 5.0,
     "tid": 1, "args": {"correlation": 7}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 300.0, "dur": 5.0,
     "tid": 1, "args": {"correlation": 8}},
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1000.0, "dur": 2000.0,
     "args": {"correlation": 7}},
    {"ph": "X", "cat": "kernel", "name": "conv", "ts": 2500.0, "dur": 1000.0,
     "args": {"correlation": 8}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 6000.0, "dur": 1000.0,
     "args": {"correlation": 9}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 3400.0,
     "dur": 2700.0, "tid": 1, "args": {"correlation": 10}},
]


def test_busy_is_the_union_of_device_intervals():
    t = chrome(EVENTS)
    assert t.busy_s() == pytest.approx(3.5e-3)
    assert t.idle_pct() == pytest.approx(65.0)
    assert t.kernel_s() == pytest.approx(3e-3)


def test_kernels_are_attributed_to_the_call_that_launched_them():
    t = chrome(EVENTS)
    assert t.kernels_under(": fused_decoder_stage") == (1, pytest.approx(2e-3))
    assert t.kernels_under(": other") == (0, 0)


def test_breakdown_names_ops_and_gaps():
    b = chrome(EVENTS).breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(2e-3)]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(2.5e-3)]]


def run_of(trace, **kw):
    ctx = SimpleNamespace(config=harness.config("fastdepth-pruned-224"),
                          workload=harness.workload("fastdepth.batch-b512"))
    outcome = SimpleNamespace(end_to_end={"frames_per_s": 1000.0}, counters=kw)
    from perfbench.work import mobilenet_skipadd

    return SimpleNamespace(ctx=ctx, outcome=outcome, trace=trace, python_trace=trace,
                           work=mobilenet_skipadd)


def test_readers_return_nothing_without_something_to_read():
    for name in harness.bench()["per_layer"]:
        if name["name"] == "mfu_pct":
            continue
        assert harness.module("metrics", name["name"]).read(run_of(None)) is None


def test_readers_on_a_trace():
    t = chrome(EVENTS)
    t.counts.update(frames=10, steps=1)
    r = run_of(t, frames=96, batches=4, batch_size=32)
    m = lambda n: harness.module("metrics", n).read(r)  # noqa: E731
    assert m("device_idle_pct.throughput") == pytest.approx(65.0)
    assert m("device_ms_per_frame.b1") == pytest.approx(0.3)
    assert m("device_idle_pct.serve") == pytest.approx(65.0)
    assert m("batch_fill_pct.serve") == pytest.approx(75.0)
    assert m("mfu_pct") == pytest.approx(100 * 0.732786768e9 * 1000 / 989e12)
    from perfbench import peaks
    from perfbench.work import mobilenet_skipadd

    least = sum(peaks.least_time_s(b, f, "bfloat16")
                for b, f in mobilenet_skipadd.decoder_levels(r.ctx.config, 512, 2))
    assert m("decoder_roofline_pct") == pytest.approx(100 * least / 5 / 2e-3)
