"""The span window: a traced window that keeps the program's own spans,
for the per-layer metrics that hang kernels and idle time on them.

The program marks its layers with ``torch.profiler`` spans
(``fastdepth_tpu_torch/engine/profiler.py``): ``fastdepth.step`` around
a step's host enqueue, ``fastdepth.encoder``, ``fastdepth.decoder`` and
``fastdepth.metrics`` inside it, ``fastdepth::fused_decoder_stage``
around each eager K1 level.  A span is an interval of a host thread, so
a kernel belongs to the span that was open on the thread that launched
it (found by the launch's correlation id), and the card's idle time,
its clock put on the host's, can be split by the spans the host was
inside.

The windows of ``perfbench/trace.py`` keep the card's activity and, for
the readers that ask, Python calls; they drop spans.  This window comes
on top of them and leaves them as they are: the first reader of a
``--trace 1`` run that asks for it (:func:`of`) sets the program up
again from the cell's files and seed, as the cell's entry does, runs the
entry's load for the workload's ``trace_seconds`` under the profiler
(the card's activity and the host's operators and spans, no Python
calls), and keeps the window on the run for the run's other readers.  It
runs after the run's other windows and its check, so nothing they read
changes.  A program without spans gives a window without them, in which
the readers find nothing to read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from perfbench import peaks, program
from perfbench.trace import Trace

SPAN_CAT = "user_annotation"  # a record_function span on the host
STEP = "fastdepth.step"
ENCODER = "fastdepth.encoder"
DECODER = "fastdepth.decoder"
METRICS = "fastdepth.metrics"
K1 = "fastdepth::fused_decoder_stage"


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclass
class SpanTrace(Trace):
    """A :class:`perfbench.trace.Trace` that also keeps the host's spans,
    each ``(name, start_us, dur_us, tid)``."""

    spans: List[tuple] = field(default_factory=list)

    @classmethod
    def from_chrome(cls, events: List[dict], window_s: float) -> "SpanTrace":
        t = super().from_chrome(events, window_s)
        t.spans = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)), e.get("tid"))
                   for e in events if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]
        return t

    def count(self, name: str) -> int:
        """How many spans named ``name`` the window holds."""
        return sum(1 for s in self.spans if s[0] == name)

    def kernels_in(self, name: str) -> Tuple[int, float]:
        """(kernels, device seconds) of the kernels launched while a span
        named ``name`` was open on the launching thread."""
        open_: Dict[object, List[Tuple[float, float]]] = {}
        for n, ts, dur, tid in self.spans:
            if n == name:
                open_.setdefault(tid, []).append((ts, ts + dur))
        starts = {tid: [a for a, _ in sorted(iv)] for tid, iv in open_.items()}
        ends = {tid: [b for _, b in sorted(iv)] for tid, iv in open_.items()}
        inside = set()
        for _, ts, _, corr, tid in self.launches:
            i = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if i >= 0 and ts <= ends[tid][i]:
                inside.add(corr)
        hits = [r for r in self.kernels if r[3] in inside]
        return len(hits), sum(r[2] for r in hits) / 1e6

    def device_clock(self) -> Tuple[float, float, float]:
        """``(x0, a, b)``: a device operation launched at host time ``x``
        leads its launch by at least ``a + b * (x - x0)`` us.  The card's
        timestamps in a trace drift from the host's, by up to milliseconds
        over a window on the H100 (PERF.md §6), as two clocks at slightly
        different rates.  No operation starts before its launch, and one
        launched onto an idle card starts within microseconds of it, so
        the line is the highest that no launch's lead falls below, on
        average over the launches: the edge of the leads' lower hull over
        their mean host time.  ``(0, 0, 0)`` without a launch."""
        start = {corr: ts for _, ts, _, corr, _ in self.launches}
        pts = sorted((start[c], ts - start[c]) for _, ts, _, c in self.device if c in start)
        if not pts:
            return 0.0, 0.0, 0.0
        x0 = pts[0][0]
        hull: List[Tuple[float, float]] = []
        for x, d in ((x - x0, d) for x, d in pts):
            while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (d - hull[-2][1])
                                      - (hull[-1][1] - hull[-2][1]) * (x - hull[-2][0])) <= 0:
                hull.pop()
            if hull and hull[-1][0] == x:
                continue  # the lower lead at this host time came first
            hull.append((x, d))
        if len(hull) == 1:
            return x0, hull[0][1], 0.0
        mean = sum(x for x, _ in pts) / len(pts) - x0
        i = min(max(bisect.bisect_left([x for x, _ in hull], mean), 1), len(hull) - 1)
        (xa, da), (xb, db) = hull[i - 1], hull[i]
        b = (db - da) / (xb - xa)
        return x0, da - b * xa, b

    def idle_s_in(self, name: str) -> float:
        """Seconds in which the host was inside a span named ``name`` (on
        any thread) and no device operation ran, the card's timestamps put
        on the host's clock (:meth:`device_clock`)."""
        x0, a, b = self.device_clock()

        def host(ts):  # ts = x + a + b (x - x0), solved for x
            return (ts - a + b * x0) / (1.0 + b)
        busy = _merged((host(ts), host(ts + dur)) for _, ts, dur, _ in self.device)
        idle, j = 0.0, 0
        for a, b in _merged((ts, ts + dur) for n, ts, dur, _ in self.spans if n == name):
            covered = 0.0
            while j < len(busy) and busy[j][1] <= a:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < b:
                covered += min(b, busy[k][1]) - max(a, busy[k][0])
                k += 1
            idle += (b - a) - covered
        return idle / 1e6


def idle_pct_in(t: Optional[SpanTrace], name: str) -> Optional[float]:
    """100 x the window's seconds with the host inside ``name`` and the
    card idle, over the window; None without such a span or without
    device activity."""
    if t is None or not t.device or not t.count(name) or t.window_s <= 0:
        return None
    return 100.0 * t.idle_s_in(name) / t.window_s


def conv_mfu_pct(run, span: str, encoder: bool) -> Optional[float]:
    """The FLOPs a frame's encoder convs (``encoder``) or its other convs
    need (``perfbench/work``, ``needed_macs``) times the span window's
    frames, over the device seconds of the kernels under ``span``, over
    the dtype's published peak, in %; None where no kernel fell under it."""
    t = of(run)
    if t is None:
        return None
    n, device_s = t.kernels_in(span)
    frames = t.counts.get("frames")
    if not n or device_s <= 0 or not frames:
        return None
    flops = 2.0 * sum(c["needed_macs"] for c in run.work.convs(run.ctx.config)
                      if c["name"].startswith("encoder.") == encoder)
    return 100.0 * flops * frames / device_s / peaks.FLOPS[run.ctx.workload["dtype"]]


@contextlib.contextmanager
def traced(device: str) -> Iterator[dict]:
    """Profile the host's operators and spans, and on a card its
    activity, inside the block, without Python calls; the block waits for
    its own device work before it ends.  Yields a dict that holds the
    :class:`SpanTrace` under ``'trace'`` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out: dict = {}
    with profile(activities=acts, with_stack=False) as prof:
        t0 = time.perf_counter()
        yield out
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-spans-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = SpanTrace.from_chrome(events, window_s)


def _batch(ctx) -> Callable[[], dict]:
    """``perfbench/entries/batch.py``'s set-up, warm-up and traced load:
    the closed loop over ``Evaluator.__call__``, one step in flight."""
    import torch
    from fastdepth_tpu_torch.engine.evaluator import Evaluator

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    b, ring = wl["batch"], wl["ring"]
    h, w = cfg["image_size"]
    model, params = program.load(cfg, program.draw_params(cfg, ctx.seed, dev), dev)
    ev = Evaluator(model, params, batch_size=b, dtype=getattr(torch, wl["dtype"]),
                   impl=wl["impl"], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed + 1)
    rgb = torch.randint(0, 256, (ring, b, h, w, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    depth = torch.rand((ring, b, h, w, 1), generator=g, device=dev) * 9.5 + 0.5
    for i in range(wl["warmup_steps"]):
        ev(rgb[i % ring], depth[i % ring])[1].cpu()

    def go():
        steps, fetch = 0, None
        t0 = time.perf_counter()
        while True:
            _, rows = ev(rgb[steps % ring], depth[steps % ring])
            if fetch is not None:
                fetch.cpu()
            fetch, steps = rows, steps + 1
            if time.perf_counter() - t0 >= wl["trace_seconds"]:
                break
        fetch.cpu()
        return {"steps": steps, "frames": steps * b}
    return go


def _deploy(ctx) -> Callable[[], dict]:
    """``perfbench/entries/deploy.py``'s set-up, warm-up and traced load:
    a host frame to the card, the compiled b1 forward, the depth back."""
    import torch
    from fastdepth_tpu_torch.engine.aot import compile_forward

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    ring = wl["ring"]
    h, w = cfg["image_size"]
    model, params = program.load(cfg, program.draw_params(cfg, ctx.seed, dev), dev)
    fn, prepared = compile_forward(model, params, batch_size=1, image_size=(h, w),
                                   dtype=getattr(torch, wl["dtype"]), impl=wl["impl"],
                                   device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed + 1)
    frames = list(torch.rand((ring, 1, h, w, 3), generator=g, device=dev).cpu().unbind(0))
    for i in range(wl["warmup_frames"]):
        fn(prepared, frames[i % ring].to(dev)).cpu()

    def go():
        i = 0
        t0 = time.perf_counter()
        while True:
            fn(prepared, frames[i % ring].to(dev)).cpu()
            i += 1
            if time.perf_counter() - t0 >= wl["trace_seconds"]:
                break
        return {"frames": i}
    return go


LOADS = {"batch": _batch, "deploy": _deploy}


def of(run) -> Optional[SpanTrace]:
    """The run's span window, made on the first call and kept on the run
    as ``span_trace``; None outside a ``--trace 1`` run (no traced window)
    and for an entry without a load here."""
    if not hasattr(run, "span_trace"):
        load = LOADS.get(run.ctx.workload["entry"]) if run.trace is not None else None
        run.span_trace = None
        if load is not None:
            go = load(run.ctx)
            with traced(run.ctx.device) as t:
                counts = go()
            t["trace"].counts.update(counts)
            run.span_trace = t["trace"]
    return run.span_trace
