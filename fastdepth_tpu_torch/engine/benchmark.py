"""Timing on the card: CUDA events around warmed-up calls.

Counterpart of ``fastdepth_tpu/engine/benchmark.py``.  PyTorch returns
before the device finishes, so every time here is read off CUDA events
recorded on the current stream, after a ``torch.cuda.synchronize``.
These helpers need a CUDA device and fail without one: a time taken on
the host's CPU is not a device time.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def sync() -> None:
    """Wait for all queued device work."""
    torch.cuda.synchronize()


def time_fn(fn: Callable, args=(), *, warmup: int = 5, repeats: int = 20) -> Dict[str, float]:
    """Single-call latency: each repeat runs one call between two events
    and waits for it, so launch overhead and idle gaps count."""
    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    arr = np.asarray(times)
    return {"mean_s": float(arr.mean()), "median_s": float(np.median(arr)),
            "std_s": float(arr.std()), "min_s": float(arr.min())}


def time_pipelined(fn: Callable, args=(), *, warmup: int = 3, calls: int = 30) -> Dict[str, float]:
    """Steady-state throughput: ``calls`` back-to-back calls between two
    events (the device runs them in order), time per call."""
    for _ in range(warmup):
        fn(*args)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    end.synchronize()
    total = start.elapsed_time(end) / 1e3
    return {"mean_s": total / calls, "median_s": total / calls,
            "total_s": total, "calls": float(calls)}
