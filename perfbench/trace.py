"""The traced window: ``torch.profiler`` over the card, and what the
per-layer metrics read from its trace.

Traced windows come after the measured window, on the same path and
load, so a ``--trace 1`` run measures its main window exactly as a
``--trace 0`` run does.  The first records the card's activity alone
(kernels, copies, and the host's CUDA calls that launched them, linked
by correlation ids): the idle share and the breakdown come from it.
Where a metric of the cell attributes kernels to the Python function
that launched them, a second window records the host's operators and
Python calls too; their cost to the host stays out of the first.  A
trace is written as Chrome JSON under the run's temporary directory,
read, and deleted.
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

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # a device operation's name as the breakdown gives it


@dataclass
class Trace:
    """Events of a traced window, each ``(name, start_us, dur_us, key)``
    with ``key`` the correlation id (device events and launches) or the
    host thread (Python calls)."""

    window_s: float = 0.0
    device: List[tuple] = field(default_factory=list)
    kernels: List[tuple] = field(default_factory=list)
    launches: List[tuple] = field(default_factory=list)
    python: List[tuple] = field(default_factory=list)
    counts: Dict[str, float] = field(default_factory=dict)  # work done in the window

    @classmethod
    def from_chrome(cls, events: List[dict], window_s: float) -> "Trace":
        t = cls(window_s=window_s)
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            args = e.get("args", {})
            row = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            if cat in DEVICE_CATS:
                t.device.append(row + (args.get("correlation"),))
                if cat == "kernel":
                    t.kernels.append(t.device[-1])
            elif cat in LAUNCH_CATS:
                t.launches.append(row + (args.get("correlation"), e.get("tid")))
            elif cat == "python_function":
                t.python.append(row + (e.get("tid"),))
        return t

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals, within the window."""
        total, end = 0.0, None
        for _, ts, dur, _ in sorted(self.device, key=lambda r: r[1]):
            if end is None or ts > end:
                total += dur
                end = ts + dur
            elif ts + dur > end:
                total += ts + dur - end
                end = ts + dur
        return min(total / 1e6, self.window_s)

    def idle_pct(self) -> Optional[float]:
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_s(self) -> float:
        return sum(r[2] for r in self.kernels) / 1e6

    def kernels_under(self, suffix: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels launched inside a
        Python call whose name ends with ``suffix`` (``file(line):
        function``), on the same host thread."""
        calls: Dict[object, List[Tuple[float, float]]] = {}
        for name, ts, dur, tid in self.python:
            if name.endswith(suffix):
                calls.setdefault(tid, []).append((ts, ts + dur))
        starts = {tid: [a for a, _ in sorted(c)] for tid, c in calls.items()}
        ends = {tid: [b for _, b in sorted(c)] for tid, c in calls.items()}
        inside = set()
        for _, ts, _, corr, tid in self.launches:
            i = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if i >= 0 and ts <= ends[tid][i]:
                inside.add(corr)
        hits = [r for r in self.kernels if r[3] in inside]
        return len(hits), sum(r[2] for r in hits) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took the most time, and the ten
        longest gaps with no device operation, each named by the innermost
        host call (a CUDA call, or a Python call where recorded) under
        way when the gap opened."""
        by_name: Dict[str, float] = {}
        for name, _, dur, _ in self.device:
            by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host = [(n, ts, ts + d) for n, ts, d, *_ in self.launches + self.python]
        named = []
        for a, b in gaps:
            under = [(e - s, n) for n, s, e in host if s <= a <= e]
            named.append([min(under)[1][:NAME_CHARS] if under else "host, outside any CUDA call",
                          (b - a) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


@contextlib.contextmanager
def traced(python: bool = False) -> Iterator[dict]:
    """Profile the card inside the block; the block waits for its own
    device work before it ends.  Yields a dict that holds the
    :class:`Trace` under ``'trace'`` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if python else [])
    out: dict = {}
    with profile(activities=acts, with_stack=python) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace.from_chrome(events, window_s)


def windows(python: bool, prepare: Callable[[], Callable[[], dict]]) -> Dict[str, Trace]:
    """The traced windows of a ``--trace 1`` run: ``'trace'``, of the
    card's activity alone, and with ``python`` ``'python_trace'``, with
    the host's Python calls.  ``prepare()`` readies a window's load
    outside the profiler and returns the function that runs it inside,
    which returns the window's counts of work done."""
    out = {}
    for key, with_python in (("trace", False), ("python_trace", True))[:1 + bool(python)]:
        go = prepare()
        with traced(with_python) as t:
            counts = go()
        t["trace"].counts.update(counts)
        out[key] = t["trace"]
    return out
