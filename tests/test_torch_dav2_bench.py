"""The benchmark's Depth Anything V2 Large additions: the work counts
(``perfbench/work/dinov2_dpt.py``) against ``torch.utils.flop_counter``
on the plain reference, the entries ``BENCHMARK.json`` gains (one
configuration, one cell, ``attention_mfu_pct``, the cell appended to
seven metrics), and the cell's load on the CPU through the harness at
ViT-S/14's widths on 56 x 56 frames (a ViT-L step is too large for a
CPU test).  The reader of ``attention_mfu_pct`` is tested with the other span
readers, in ``tests/test_torch_span_metrics.py``."""

import contextlib
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, program, spans
from perfbench import trace as T
from perfbench.work import dinov2_dpt as WD
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

CONFIG = "depth-anything-v2-vitl-518"
CELL = "dav2-vitl.batch-b64"
VITS = dict(embed_dim=384, depth=12, num_heads=6, mlp_dim=1536, taps=[2, 5, 8, 11], features=64,
            decoder_channels=[48, 96, 192, 384],
            port_model={"encoder": "dinov2_vits14", "decoder": "dpt", "skip": None})
APPENDED = ("frames_per_s", "device_idle_pct.throughput", "mfu_pct", "encoder_mfu_pct",
            "decoder_mfu_pct", "metrics_us_per_frame", "launch_idle_pct.throughput")


def counted(cfg):
    """FLOPs of the reference's forward of one frame, as the counter sees
    them (meta tensors: nothing runs)."""
    sd = {r[0]: torch.zeros(r[1], device="meta") for r in program.reference(cfg).schema(cfg)}
    x = torch.zeros((1, *cfg["image_size"], 3), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        program.reference(cfg).forward(sd, x, cfg)
    return fc.get_total_flops()


@pytest.mark.parametrize("widths,size", [("vits", [56, 56]), ("vits", [70, 42]),
                                         ("vitl", [518, 518])])
def test_the_work_counts_equal_the_counters(widths, size):
    cfg = harness.config(CONFIG)
    if widths == "vits":
        cfg.update(VITS)
    cfg["image_size"] = size
    assert WD.step_flops(cfg) == counted(cfg)


def test_the_published_totals():
    cfg = harness.config(CONFIG)
    rows = WD.convs(cfg)
    enc = 2 * sum(c["needed_macs"] for c in rows if c["name"].startswith("encoder."))
    attn = 2 * sum(c["needed_macs"] for c in rows if ".attn_" in c["name"])
    assert WD.tokens(cfg) == 1370 and attn == WD.attention_flops(cfg) == 4 * 1370 ** 2 * 1024 * 24
    assert round(WD.step_flops(cfg) / 1e12, 2) == 1.30
    assert round(enc / 1e12, 2) == 1.01 and round(attn / 1e12, 3) == 0.185
    assert all(c["macs"] == c["needed_macs"] for c in rows)


def test_the_benchmark_gains_the_cell_and_its_metric():
    b = harness.bench()
    conf = next(c for c in b["configs"] if c["name"] == CONFIG)
    assert b["configs"][-1] == conf and conf["reduced"] == []
    assert harness.load_json(os.path.join(harness.ROOT, conf["file"]))["name"] == CONFIG
    cell = harness.cell_entry(CELL)
    assert b["workloads"][-1] == cell and (cell["config"], cell["chips"]) == (CONFIG, 1)
    attention = b["per_layer"][-1]
    assert attention == {"name": "attention_mfu_pct", "unit": "%", "better": "higher",
                         "source": "program_span", "layer": "kernels",
                         "moves": "frames_per_s", "workloads": [CELL]}
    for m in b["end_to_end"] + b["per_layer"]:
        listed = m.get("workloads")
        if m["name"] in APPENDED:
            assert listed[-1] == CELL and listed.count(CELL) == 1
        elif listed is not None:
            assert CELL not in listed or m["name"] == "attention_mfu_pct"
    wanted = harness.metrics_of(CELL)
    assert {m["name"] for m in wanted["end_to_end"]} == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in wanted["per_layer"]} == set(APPENDED[1:]) | {"attention_mfu_pct"}
    wl = harness.workload(CELL)
    assert (wl["entry"], wl["batch"], wl["dtype"], wl["impl"], wl["ring"]) == (
        "batch", 64, "bfloat16", "auto", 8)
    assert (wl["warmup_steps"], wl["sample_steps"], wl["sample_from"], wl["trace_seconds"]) == (
        3, 3, 32, 2)
    assert set(wl["limits"]) == {"pred_rel_l2", "metric_gap"}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A copy of the benchmark whose configuration is ViT-S/14 at 56 x 56
    and whose cells run 4 frames a step; the card-only windows faked."""
    from perfbench.tests.conftest import tiny_root

    @contextlib.contextmanager
    def card_only(python=False):
        out = {}
        yield out
        out["trace"] = T.Trace(window_s=1.0)
    monkeypatch.setattr(T, "traced", card_only)
    root = tiny_root(str(tmp_path))
    path = os.path.join(root, "perfbench", "configs", f"{CONFIG}.json")
    cfg = harness.load_json(path)
    cfg.update(VITS, image_size=[56, 56])
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def test_the_cells_load_runs_through_the_harness(tiny, monkeypatch):
    from perfbench import run

    made = []
    monkeypatch.setattr(spans, "of", lambda r, of=spans.of: made.append(r) or of(r))
    r = run.measure(CELL, 2 ** 31 + 13, 0.2, True, root=tiny, device="cpu",
                    check_device=False)
    assert r["correct"], r["compared"]
    t = made[0].span_trace
    steps = t.counts["frames"] // harness.workload(CELL, tiny)["batch"]
    assert steps >= 1 and t.count(spans.STEP) == t.count(spans.METRICS) == steps
    assert t.count(spans.ENCODER) == t.count(spans.DECODER) == steps
    attention = harness.module("metrics", "attention_mfu_pct", tiny).ATTENTION
    assert t.count(attention) == VITS["depth"] * steps
    # no card: nothing under a span, so no span metric to report
    assert "attention_mfu_pct" not in r["metrics"] and "mfu_pct" in r["metrics"]
