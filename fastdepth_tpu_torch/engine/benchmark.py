"""Benchmark protocol: warmup runs then timed repeats, mirroring the
reference's TVM ``time_evaluator`` flow (deploy/tx2_run_tvm.py:42-65).

Counterpart of ``fastdepth_tpu/engine/benchmark.py``.  PyTorch returns
before the card finishes, so on a CUDA device every time here is read off
CUDA events recorded on the current stream around the timed calls, after
a ``sync``.  ``device="cpu"`` times the plain versions with the host
clock (CPU ops finish before they return): that is a CPU time, and the
caller names it so.  The default device is the card, and without one the
helpers fail rather than time the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def sync(device: Device = "cuda") -> None:
    """Wait for all queued work on ``device`` (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stopwatch(device: Device) -> Callable[[Callable[[], object]], float]:
    """``measure(run)``: seconds that ``run()`` takes on ``device``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        def measure(run):
            t0 = time.perf_counter()
            run()
            return time.perf_counter() - t0
        return measure
    if dev.type != "cuda":
        raise ValueError(f"cannot time on a {dev.type} device")

    def measure(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return measure


def card_info() -> Dict[str, str]:
    """The card a measurement ran on: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, the device count, and the torch and CUDA versions.
    Raises without a card."""
    import subprocess

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a measurement of the card needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"nvidia_smi": smi.stdout.strip().splitlines()[0],
            "name": torch.cuda.get_device_name(0), "count": str(torch.cuda.device_count()),
            "torch": torch.__version__, "cuda": str(torch.version.cuda)}


def _stats(times) -> Dict[str, float]:
    arr = np.asarray(times)
    return {"mean_s": float(arr.mean()), "median_s": float(np.median(arr)),
            "std_s": float(arr.std()), "min_s": float(arr.min())}


def time_fn(fn: Callable, args=(), *, warmup: int = 5, repeats: int = 20,
            device: Device = "cuda") -> Dict[str, float]:
    """Single-call latency: each repeat times one call and waits for it,
    so launch overhead and idle gaps count."""
    for _ in range(warmup):
        fn(*args)
    sync(device)
    measure = _stopwatch(device)
    return _stats([measure(lambda: fn(*args)) for _ in range(repeats)])


def time_randomized(fn: Callable, make_input: Callable[[int], object], *, warmup: int = 5,
                    repeats: int = 20, device: Device = "cuda") -> Dict[str, float]:
    """Randomized-input variant (deploy/tx2_run_tvm.py:56-65): a fresh
    input for every call, made and put on the device outside the timed
    region, so nothing can be cached from one call to the next."""
    for i in range(warmup):
        fn(make_input(i))
    sync(device)
    measure = _stopwatch(device)
    times = []
    for i in range(repeats):
        x = make_input(warmup + i)
        sync(device)
        times.append(measure(lambda: fn(x)))
    return _stats(times)


def time_graph(fn: Callable, args=(), *, calls: int = 20) -> float:
    """Device seconds per call: ``calls`` calls of ``fn(*args)`` captured
    in one CUDA graph (after 3 warm-up calls), the graph replayed between
    CUDA events (median of 3 replays).  The card runs the calls' kernels back to back with no
    host launch in between, so unlike :func:`time_pipelined` a call
    shorter than its host launch time reads as its own device time.
    ``fn`` must not synchronise with the host.  Capturing runs ``fn``'s
    Python ``calls`` times (a wrapper's launch count rises by that much);
    the replays run the kernels without it.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_graph needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as CUDA graphs want
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    measure = _stopwatch("cuda")
    times = [measure(graph.replay) for _ in range(3)]
    return float(np.median(times)) / calls


def time_pipelined(fn: Callable, args=(), *, warmup: int = 3, calls: int = 30,
                   device: Device = "cuda") -> Dict[str, float]:
    """Steady-state throughput: ``calls`` back-to-back calls timed as one
    span (the device runs them in order), time per call."""
    for _ in range(warmup):
        fn(*args)
    sync(device)

    def run():
        for _ in range(calls):
            fn(*args)
    total = _stopwatch(device)(run)
    return {"mean_s": total / calls, "median_s": total / calls,
            "total_s": total, "calls": float(calls)}
