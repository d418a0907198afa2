"""Fixtures of the benchmark's tests: a copy of the benchmark at a size
the CPU holds, which a test may add files to."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from perfbench import harness

TINY = {"image_size": [64, 64]}
# the lines of BENCHMARK.json that bring back the serving cell, which
# waits outside it (PERF.md, Open questions): its files are in place
SERVE_CELL = {
    "workloads": [{"name": "fastdepth.serve-socket", "config": "fastdepth-pruned-224",
                   "traffic": "serve-socket", "chips": 1, "why": "a parked cell"}],
    "end_to_end": [{"name": "served_frames_per_s", "unit": "frames/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["fastdepth.serve-socket"]}],
    "per_layer": [{"name": n, "unit": "%", "better": b, "source": s, "layer": layer,
                   "moves": "served_frames_per_s", "workloads": ["fastdepth.serve-socket"]}
                  for n, b, s, layer in [
                      ("device_idle_pct.serve", "lower", "device_trace", "device"),
                      ("batch_fill_pct.serve", "higher", "program_counter", "engine")]],
}

# the flagship's b128 cell, which fastdepth.batch-b512 replaced in
# BENCHMARK.json and which tests outside perfbench/ still run (PERF.md,
# Open questions): its file stays, and the copy lists it after the cells
# and in every metric list that names the cell that replaced it
RETIRED_CELL, SUCCESSOR = "fastdepth.batch-b128", "fastdepth.batch-b512"


def tiny_root(dst: str) -> str:
    """A copy of ``BENCHMARK.json``, with the serving cell's and the
    retired flagship cell's lines added, and of ``perfbench/``, whose
    configurations take 64 x 64 frames and whose cells run a few frames
    a step."""
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"), os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.bench()
    for key, entries in SERVE_CELL.items():
        bench[key] += entries
    successor = next(w for w in bench["workloads"] if w["name"] == SUCCESSOR)
    bench["workloads"].append(dict(successor, name=RETIRED_CELL, traffic="batch-b128"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if SUCCESSOR in m.get("workloads", ()):
            m["workloads"].append(RETIRED_CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name in os.listdir(os.path.join(dst, "perfbench", "configs")):
        path = os.path.join(dst, "perfbench", "configs", name)
        cfg = harness.load_json(path)
        cfg.update(TINY)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for cell in harness.cells(dst):
        path = os.path.join(dst, "perfbench", "workloads", f"{cell}.json")
        wl = harness.load_json(path)
        wl.update(batch=min(wl["batch"], 4), trace_seconds=0.2)
        if wl["entry"] == "batch":
            wl.update(sample_from=2, sample_steps=1, warmup_steps=1)
        elif wl["entry"] == "deploy":
            wl.update(sample_from=4, sample_frames=2, warmup_frames=2)
        else:
            wl.update(rate=40, warmup_requests=1, sample_requests=2, deadline_s=30)
        with open(path, "w") as f:
            json.dump(wl, f)
    return dst


@pytest.fixture
def root(tmp_path):
    return tiny_root(str(tmp_path))
