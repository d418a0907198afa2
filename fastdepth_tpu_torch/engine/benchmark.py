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

import math
import time
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]

# Twice the H100's 50 MB L2: a replay of :func:`time_graph` that cycles
# through this many bytes of distinct operands reads them from device
# memory, as a caller on the main path does.
COLD_BYTES = 100 * 2 ** 20


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


def cold_copies(nbytes: int, cold_bytes: int = COLD_BYTES) -> int:
    """How many distinct copies of a call's operands (``nbytes`` read and
    written per call) one cycle of :func:`time_graph` needs to touch
    ``cold_bytes``, so that no call finds its operands in L2."""
    return max(1, math.ceil(cold_bytes / max(1, nbytes)))


def time_graph(fn: Callable, arg_sets: Sequence[tuple], *, calls: int = 20) -> float:
    """Device seconds per call: ``max(calls, len(arg_sets))`` calls of
    ``fn``, call ``i`` on ``arg_sets[i % len(arg_sets)]``, captured in one
    CUDA graph (after a warm-up call on each set), the graph replayed
    between CUDA events (median of 3 replays).  Distinct argument sets
    whose bytes together exceed the L2 (:func:`cold_copies`) make every
    call read its operands from device memory; one set replays warm.
    The card runs the calls' kernels back to back with no host launch in
    between, so unlike :func:`time_pipelined` a call shorter than its host
    launch time reads as its own device time.  ``fn`` must not
    synchronise with the host.  Capturing runs ``fn``'s Python once per
    call (a wrapper's launch count rises by that much); the replays run
    the kernels without it.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_graph needs a CUDA device")
    if not arg_sets or not all(isinstance(a, tuple) for a in arg_sets):
        raise ValueError("time_graph takes a non-empty list of argument tuples")
    calls = max(calls, len(arg_sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as CUDA graphs want
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    measure = _stopwatch("cuda")
    times = [measure(graph.replay) for _ in range(3)]
    return float(np.median(times)) / calls


def launch_floor_us(calls: int = 20) -> float:
    """The least a kernel launch costs in :func:`time_graph`'s timer: the
    device microseconds per call of a one-element ``zero_()``.  A call
    whose bound is below this reads as this at best.  Needs a CUDA
    device."""
    t = torch.empty(1, device="cuda")
    return time_graph(lambda a: a.zero_(), [(t,)], calls=calls) * 1e6


def kernel_names(fn: Callable, args=()) -> list:
    """The CUDA kernels one call of ``fn(*args)`` launches, by name, as
    ``torch.profiler`` traces them (after one untraced warm-up call);
    empty where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]


def tolerance(want: torch.Tensor) -> float:
    """How far a kernel may stray from its plain version ``want`` (the
    plain result in the kernel's dtype): f32 1e-4 * max(1, max|plain|),
    the order of the sums only (TF32 off); bf16 2^-7 * max|plain|, one
    bf16 rounding of the output plus the order."""
    scale = float(want.float().abs().max())
    return 1e-4 * max(1.0, scale) if want.dtype == torch.float32 else 2.0 ** -7 * scale


def compare_and_time(fn: Callable, plain: Callable, arg_sets: Sequence[tuple], *,
                     counter=None, calls: int = 20) -> Dict[str, float]:
    """A kernel's wrapper ``fn`` against its ``plain`` version on the card:
    max|diff| on ``arg_sets[0]`` against :func:`tolerance` (``ok``), then
    both device times per call (:func:`time_graph` cycling through
    ``arg_sets``, which should hold :func:`cold_copies` distinct sets) and
    both CUDA-event times of pipelined calls on the first set (host launch
    time included where a call is shorter than it).  ``counter``, a
    kernel's label ("K1" ... "K7"), must rise by one in
    ``ops/cuda/kernel.COUNTER`` on the checked call: a wrapper that did
    not launch its kernel raises.  Needs a CUDA device."""
    from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER

    if not torch.cuda.is_available():
        raise RuntimeError("compare_and_time needs a CUDA device")
    with torch.inference_mode():
        before = COUNTER[counter]
        got = fn(*arg_sets[0])
        if counter is not None and COUNTER[counter] != before + 1:
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} did not launch its kernel")
        want = plain(*arg_sets[0])
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = tolerance(want)
        row = {"max_abs_err": err, "tol": tol,
               "ok": bool(err <= tol and torch.isfinite(got.float()).all()),
               "copies": len(arg_sets)}
        for key, f in (("", fn), ("plain_", plain)):
            row[f"{key}us"] = time_graph(f, arg_sets, calls=calls) * 1e6
            row[f"{key}events_us"] = float(np.median(
                [time_pipelined(f, arg_sets[0], calls=calls)["mean_s"] for _ in range(3)])) * 1e6
    return row


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


def throughput_sweep(model, params, *, batch_sizes: Sequence[int] = (1, 32, 128),
                     dtype: torch.dtype = torch.float32, image_size=(224, 224),
                     warmup: int = 3, calls: int = 30,
                     device: Device = "cuda") -> Dict[str, Dict[str, float]]:
    """Amortized frames/s per batch size of a model's folded straight
    forward (``compile_forward(impl="xla")``, :func:`time_pipelined` on a
    seeded input), keyed by the batch size as a string; each row is
    :func:`time_pipelined`'s with ``fps = b / mean_s``.  ``params`` must
    already be folded (``Model.fold``): the sweep would otherwise time the
    unfolded-BN forward while claiming the folded one."""
    from fastdepth_tpu_torch.engine.aot import compile_forward
    from fastdepth_tpu_torch.models.fused import tree_has_bn

    if tree_has_bn(params):
        raise ValueError("throughput_sweep needs pre-folded params "
                         "(Model.fold) — it documents the folded forward")
    rng = np.random.RandomState(0)
    out: Dict[str, Dict[str, float]] = {}
    for b in batch_sizes:
        compiled, prepared = compile_forward(
            model, params, batch_size=b, image_size=image_size, dtype=dtype,
            fold_bn=False,  # the caller folded
            impl="xla", device=device)
        x = torch.from_numpy(rng.rand(b, *image_size, 3).astype(np.float32)).to(device)
        stats = time_pipelined(compiled, (prepared, x), warmup=warmup, calls=calls,
                               device=device)
        stats["fps"] = b / stats["mean_s"]
        out[str(b)] = stats
    return out


# --- the least time for a kernel's work ---------------------------------

# One H100 SXM's data sheet at 700 W (dense rates): device memory
# (bytes/s), f32 operations on the CUDA cores and bf16 operations on the
# tensor cores (FLOP/s).  A bound is stated against these published peaks;
# the ceilings engine/calibrate.py measures (docs/probe_h100_hbm.json) are
# lower, and a share of them is derived from this bound where needed.
RATES = {"hbm_bps": 3.35e12, "f32_flops": 67e12, "bf16_tensor_flops": 989e12}


def bound_us(nbytes: float, core_flops: float = 0.0, tensor_flops: float = 0.0):
    """(microseconds, "bytes" or "operations"): the least time for work
    that moves ``nbytes`` (each input read once, each output written
    once), does ``core_flops`` f32 operations on the CUDA cores and
    ``tensor_flops`` bf16 operations on the tensor cores; the larger of
    the memory time and the busier unit's time, and which one binds, on
    the published :data:`RATES`."""
    r = RATES
    mem = nbytes / r["hbm_bps"] * 1e6
    ops = max(core_flops / r["f32_flops"], tensor_flops / r["bf16_tensor_flops"]) * 1e6
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def stage_work(n: int, h: int, w: int, c: int, cout: int, skip: bool, elem_bytes: int,
               tensor_cores: bool = False):
    """(bytes, CUDA-core FLOPs, tensor-core FLOPs) of one fused decoder
    level (K1-K3's function): x, the weights and the skip read once, the
    output written once; 25 FMAs per input element for the depthwise,
    C x Cout FMAs per pixel for the pointwise (on the tensor cores where
    ``tensor_cores``), and the bias/ReLU/skip adds."""
    px = n * h * w
    nbytes = elem_bytes * (px * c + 27 * c + c * cout + cout
                           + (2 if skip else 1) * 4 * px * cout)
    dw = 2 * 25 * px * c + 2 * px * c
    pw = 2 * px * c * cout
    epilogue = 2 * px * cout + (4 * px * cout if skip else 0)
    if tensor_cores:
        return nbytes, dw + epilogue, pw
    return nbytes, dw + pw + epilogue, 0
