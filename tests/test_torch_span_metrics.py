"""The benchmark's readers of the program's spans (``perfbench/spans.py``,
``perfbench/metrics/``): each computes its number from a trace whose
kernels and idle time fall under the spans, and nothing without them;
the readers that were there read the same with spans in the trace as
without; the profiler settings of the windows they read are as they
were; and the span window runs the cells' loads on the CPU."""

import contextlib
import json
from types import SimpleNamespace

import pytest

from perfbench import harness, peaks, spans
from perfbench import trace as T
from perfbench.work import mobilenet_skipadd, resnet_upproj

NEW = ("encoder_mfu_pct", "decoder_mfu_pct", "metrics_us_per_frame",
       "decoder_roofline_pct.spans", "launch_idle_pct.throughput", "launch_idle_pct.latency",
       "graph_replay_pct.latency", "attention_mfu_pct")
OLD = ("device_idle_pct.throughput", "device_idle_pct.latency", "device_ms_per_frame.b1",
       "decoder_roofline_pct", "mfu_pct")


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one step on host thread 1 (us): the encoder launches two kernels, the
# decoder two K1 levels and a head, the metrics one kernel; a copy after
# the step, and a kernel from another thread.  Device busy 150-450,
# 600-800, 860-960; the host in the step 100-1000.  Two operations start
# as their launch does: the card's clock is the host's.
SPAN_EVENTS = [
    X("user_annotation", spans.STEP, 100.0, 900.0),
    X("user_annotation", spans.ENCODER, 110.0, 290.0),
    X("user_annotation", spans.DECODER, 400.0, 400.0),
    X("user_annotation", spans.K1, 410.0, 40.0),
    X("user_annotation", spans.K1, 460.0, 40.0),
    X("user_annotation", spans.METRICS, 850.0, 140.0),
    X("gpu_user_annotation", spans.STEP, 150.0, 750.0, tid=7),
]
CARD_EVENTS = [
    X("python_function", "x/ops/cuda/fused_decoder.py(1): fused_decoder_stage", 410.0, 40.0),
    X("cuda_runtime", "cudaLaunchKernel", 150.0, 5.0, corr=1),
    X("cuda_driver", "cuLaunchKernel", 200.0, 5.0, corr=2),
    X("cuda_runtime", "cudaLaunchKernel", 420.0, 5.0, corr=3),
    X("cuda_runtime", "cudaLaunchKernel", 470.0, 5.0, corr=4),
    X("cuda_runtime", "cudaLaunchKernel", 600.0, 5.0, corr=5),
    X("cuda_runtime", "cudaLaunchKernel", 860.0, 5.0, corr=6),
    X("cuda_runtime", "cudaMemcpyAsync", 1000.0, 160.0, corr=9),
    X("cuda_runtime", "cudaLaunchKernel", 2000.0, 5.0, tid=2, corr=8),
    X("kernel", "conv", 150.0, 200.0, tid=7, corr=1),
    X("kernel", "bias_add", 350.0, 100.0, tid=7, corr=2),
    X("kernel", "k1", 600.0, 50.0, tid=7, corr=3),
    X("kernel", "k1", 650.0, 50.0, tid=7, corr=4),
    X("kernel", "k4", 700.0, 100.0, tid=7, corr=5),
    X("kernel", "sums", 860.0, 100.0, tid=7, corr=6),
    X("kernel", "other_thread", 2500.0, 10.0, tid=7, corr=8),
    X("gpu_memcpy", "Memcpy DtoH", 1100.0, 50.0, tid=7, corr=9),
]
WINDOW_S = 0.004


def span_trace(events=SPAN_EVENTS + CARD_EVENTS, frames=128):
    t = spans.SpanTrace.from_chrome(events, WINDOW_S)
    t.counts.update(frames=frames, steps=1)
    return t


def run_of(cell, t):
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    ctx = SimpleNamespace(cell=cell, config=cfg, workload=wl, device="cpu")
    return SimpleNamespace(ctx=ctx, outcome=SimpleNamespace(end_to_end={"frames_per_s": 1e3}),
                           trace=t, python_trace=t, span_trace=t,
                           work=harness.module("work", cfg["family"]))


def read(name, run):
    return harness.module("metrics", name).read(run)


def test_the_new_metrics_are_in_the_benchmark_with_their_cells():
    per_layer = {m["name"]: m for m in harness.bench()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"]
        assert callable(harness.module("metrics", name).read)


def test_spans_are_kept_and_the_rest_is_the_card_windows():
    t, plain = span_trace(), T.Trace.from_chrome(SPAN_EVENTS + CARD_EVENTS, WINDOW_S)
    assert [s[0] for s in t.spans] == [spans.STEP, spans.ENCODER, spans.DECODER, spans.K1,
                                       spans.K1, spans.METRICS]
    for key in ("device", "kernels", "launches", "python"):
        assert getattr(t, key) == getattr(plain, key)
    assert t.count(spans.K1) == 2 and t.count("absent") == 0


def test_kernels_fall_under_the_span_open_on_the_launching_thread():
    t = span_trace()
    assert t.kernels_in(spans.STEP) == (6, pytest.approx(600e-6))
    assert t.kernels_in(spans.ENCODER) == (2, pytest.approx(300e-6))
    assert t.kernels_in(spans.DECODER) == (3, pytest.approx(200e-6))
    assert t.kernels_in(spans.K1) == (2, pytest.approx(100e-6))
    assert t.kernels_in(spans.METRICS) == (1, pytest.approx(100e-6))
    assert t.kernels_in("absent") == (0, 0)


def drifted(events, lead, rate):
    """``events`` with the card's timestamps ``lead`` us ahead at host
    time 0, its clock running ``rate`` faster than the host's."""
    return [dict(e, ts=e["ts"] * (1 + rate) + lead, dur=e["dur"] * (1 + rate))
            if e["cat"] in T.DEVICE_CATS else e for e in events]


@pytest.mark.parametrize("lead,rate", [(0.0, 0.0), (-3500.0, 0.0), (250.0, 0.0),
                                       (-3500.0, -0.004), (40.0, 0.002)])
def test_idle_inside_a_span_is_the_span_less_the_device_busy(lead, rate):
    t = span_trace(drifted(SPAN_EVENTS + CARD_EVENTS, lead, rate))
    x0, a, b = t.device_clock()
    assert (x0, b) == (150.0, pytest.approx(rate))
    assert a + b * (0 - x0) == pytest.approx(lead)
    # step 100-1000; busy 150-450, 600-800, 860-960: idle 50 + 150 + 60 + 40 us
    assert t.idle_s_in(spans.STEP) == pytest.approx(300e-6)
    assert t.idle_s_in(spans.METRICS) == pytest.approx(40e-6)
    assert spans.idle_pct_in(t, spans.STEP) == pytest.approx(100 * 300e-6 / WINDOW_S)
    assert spans.idle_pct_in(t, "absent") is None
    assert spans.idle_pct_in(None, spans.STEP) is None


def test_the_new_readers_on_a_trace():
    flag = run_of("fastdepth.batch-b128", span_trace())
    up = run_of("resnet50-upproj.batch-b128", span_trace())
    cfg, upcfg = flag.ctx.config, up.ctx.config
    enc = 2 * sum(c["needed_macs"] for c in mobilenet_skipadd.convs(cfg)
                  if c["name"].startswith("encoder."))
    dec = 2 * sum(c["needed_macs"] for c in resnet_upproj.convs(upcfg)
                  if not c["name"].startswith("encoder."))
    assert read("encoder_mfu_pct", flag) == pytest.approx(100 * enc * 128 / 300e-6 / 989e12)
    assert read("decoder_mfu_pct", up) == pytest.approx(100 * dec * 128 / 200e-6 / 989e12)
    assert read("metrics_us_per_frame", flag) == pytest.approx(100.0 / 128)
    least = sum(peaks.least_time_s(b, f, "bfloat16")
                for b, f in mobilenet_skipadd.decoder_levels(cfg, 128, 2))
    assert read("decoder_roofline_pct.spans", flag) == pytest.approx(100 * least * 2 / 5 / 100e-6)
    for name in ("launch_idle_pct.throughput", "launch_idle_pct.latency"):
        assert read(name, flag) == pytest.approx(100 * 300e-6 / WINDOW_S)


@pytest.mark.parametrize("graphs,want", [(4, 100.0), (2, 50.0), (0, None)])
def test_graph_replay_share_counts_the_steps_that_replayed(graphs, want):
    """``graph_replay_pct.latency``: the share of ``fastdepth.step`` spans
    that hold a ``fastdepth.graph`` span; nothing where none opened."""
    graph = harness.module("metrics", "graph_replay_pct.latency").GRAPH
    events = [X("user_annotation", spans.STEP, 1000.0 * i, 500.0) for i in range(4)]
    events += [X("user_annotation", graph, 1000.0 * i + 100, 200.0) for i in range(graphs)]
    got = read("graph_replay_pct.latency", run_of("fastdepth.deploy-b1",
                                                  span_trace(events + CARD_EVENTS)))
    assert got == (None if want is None else pytest.approx(want))


def test_attention_mfu_reads_the_kernels_under_the_attention_span():
    """``attention_mfu_pct``: a frame's attention FLOPs times the window's
    frames over the kernels launched inside ``fastdepth.attention`` spans
    (here the two encoder kernels, 300 us), over the bf16 peak; nothing
    for a family without attention counts, or without the span."""
    attention = harness.module("metrics", "attention_mfu_pct").ATTENTION
    events = SPAN_EVENTS + [X("user_annotation", attention, 140.0, 100.0)] + CARD_EVENTS
    run = run_of("dav2-vitl.batch-b64", span_trace(events, frames=64))
    want = 100 * run.work.attention_flops(run.ctx.config) * 64 / 300e-6 / 989e12
    assert read("attention_mfu_pct", run) == pytest.approx(want)
    assert read("attention_mfu_pct", run_of("fastdepth.batch-b128", span_trace(events))) is None
    assert read("attention_mfu_pct", run_of("dav2-vitl.batch-b64", span_trace())) is None


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_reads_nothing_without_its_span(name):
    without = [e for e in SPAN_EVENTS + CARD_EVENTS if e["cat"] != "user_annotation"]
    for t in (span_trace(without), None):
        assert read(name, run_of("fastdepth.batch-b128", t)) is None
    # a traced run whose entry the span window has no load for
    run = run_of("fastdepth.batch-b128", T.Trace(window_s=1.0))
    del run.span_trace
    run.ctx.workload = dict(run.ctx.workload, entry="serve_socket")
    assert read(name, run) is None and run.span_trace is None


@pytest.mark.parametrize("name", OLD)
def test_the_readers_that_were_there_read_the_same_with_spans(name):
    def plain(events):
        t = T.Trace.from_chrome(events, WINDOW_S)
        t.counts.update(frames=128, steps=1)
        return t

    without = [e for e in SPAN_EVENTS + CARD_EVENTS if "user_annotation" not in e["cat"]]
    got = [read(name, run_of("fastdepth.batch-b128", t))
           for t in (plain(without), plain(SPAN_EVENTS + CARD_EVENTS), span_trace())]
    assert got[0] is not None and got[0] == got[1] == got[2]


class _Profile:
    """A stand-in for ``torch.profiler.profile`` that records how it was
    asked to profile and exports an empty trace."""

    made = []

    def __init__(self, activities, with_stack=False, **kw):
        _Profile.made.append((list(activities), with_stack, kw))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.fixture
def recorded(monkeypatch):
    import torch
    import torch.profiler

    _Profile.made = []
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return _Profile.made


def test_the_card_windows_keep_their_profiler_settings(recorded):
    from torch.profiler import ProfilerActivity as A

    out = T.windows(True, lambda: lambda: {"frames": 1})
    assert set(out) == {"trace", "python_trace"}
    assert recorded == [([A.CUDA], False, {}), ([A.CUDA, A.CPU], True, {})]
    recorded.clear()
    assert set(T.windows(False, lambda: lambda: {"frames": 1})) == {"trace"}
    assert recorded == [([A.CUDA], False, {})]


def test_the_span_window_records_host_and_card_without_python_calls(recorded):
    from torch.profiler import ProfilerActivity as A

    for device in ("cuda", "cpu"):
        with spans.traced(device) as t:
            pass
        assert isinstance(t["trace"], spans.SpanTrace)
    assert recorded == [([A.CPU, A.CUDA], False, {}), ([A.CPU], False, {})]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A copy of the benchmark at 64 x 64, its card-only windows faked
    (this machine has no card)."""
    from perfbench.tests.conftest import tiny_root

    @contextlib.contextmanager
    def card_only(python=False):
        out = {}
        yield out
        out["trace"] = T.Trace(window_s=1.0)
    monkeypatch.setattr(T, "traced", card_only)
    return tiny_root(str(tmp_path))


@pytest.mark.parametrize("cell,k1", [("fastdepth.batch-b128", 5),
                                     ("resnet50-upproj.batch-b128", 0),
                                     ("fastdepth.deploy-b1", 5)])
def test_the_span_window_runs_a_cells_load_and_holds_its_spans(tiny, monkeypatch, cell, k1):
    from perfbench import run

    made = []
    monkeypatch.setattr(spans, "of", lambda r, of=spans.of: made.append(r) or of(r))
    r = run.measure(cell, 2 ** 31 + 11, 0.2, True, root=tiny, device="cpu",
                    check_device=False)
    assert r["correct"]
    t = made[0].span_trace
    steps = t.counts["frames"] // harness.workload(cell, tiny)["batch"]
    assert steps >= 1 and t.count(spans.STEP) == steps
    assert t.count(spans.ENCODER) == t.count(spans.DECODER) == steps
    assert t.count(spans.K1) == k1 * steps
    assert t.count(spans.METRICS) == (0 if cell.endswith("deploy-b1") else steps)
    # no card: nothing under a span, so nothing to report
    assert not set(r["metrics"]) & set(NEW)
