"""What the serving modules share: the flagship and its seeded frame, the
server with the scripts' settings, the pipelined in-flight loop, the
window reducer, the knee rule, the kernels' launch counts, and the
modules' common flags and JSON output."""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import numpy as np
import torch

from fastdepth_tpu_torch.models.registry import Model

# the scripts' server settings (scripts/soak_server_r4.py:47-53 and the
# chain benches): bf16 compute, raw uint8 frames in, f16 out, two batches
# in flight, and no defensive copy of the one immutable frame submitted
SERVER_SETTINGS = {"dtype": torch.bfloat16, "input_dtype": np.uint8,
                   "output_dtype": np.float16, "pipeline_depth": 2, "copy_inputs": False}
RESULT_S = 900.0  # the longest a future is waited for (the scripts' timeout)
HW = 224  # the image side every module runs at (the chain modules' --hw default)


def default_out(name: str) -> str:
    """A module's default output: ``name`` in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def add_common(p, out_name: str) -> None:
    """``--device`` (the card unless the caller asks for the CPU) and
    ``--out``."""
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs on the card (the port's kernels); cpu runs their plain "
                        "PyTorch versions, and every time is a CPU time")
    p.add_argument("--out", default=default_out(out_name))


def check_device(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``; exits
    when the card is asked for and there is none."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available "
                             "(pass --device cpu to run the plain PyTorch versions)")
        from fastdepth_tpu_torch.engine.benchmark import card_info

        return card_info()["nvidia_smi"]
    return "cpu"


def flagship(seed: int = 0):
    """(model, params): the pruned flagship at random weights
    (``Model.init`` from a seeded generator), unfolded, on the CPU."""
    from fastdepth_tpu_torch.models import fastdepth_pruned

    model = fastdepth_pruned()
    return model, model.init(torch.Generator().manual_seed(seed))


def seeded_frame(hw: int = None, dtype=np.uint8, seed: int = 0) -> np.ndarray:
    """The scripts' one frame: ``rand(hw, hw, 3) * 255`` from
    ``RandomState(seed)``, as ``dtype`` (``hw``: :data:`HW` unless given)."""
    hw = HW if hw is None else hw
    return (np.random.RandomState(seed).rand(hw, hw, 3) * 255).astype(dtype)


def make_server(model, params, batch_size: int, **overrides):
    """An ``InferenceServer`` with :data:`SERVER_SETTINGS`, ``overrides``
    on top (``max_queue``, ``chain``, ``impl``, ``device``, ...)."""
    from fastdepth_tpu_torch.engine.server import InferenceServer

    return InferenceServer(model, params, batch_size=batch_size,
                           **{**SERVER_SETTINGS, **overrides})


def pipelined(submit, frame: np.ndarray, frames: int, depth: int) -> float:
    """One client keeping ``depth`` requests in flight (a deque of
    futures) until ``frames`` are answered; returns the seconds."""
    inflight = collections.deque()
    t0 = time.perf_counter()
    for _ in range(frames):
        inflight.append(submit(frame))
        if len(inflight) >= depth:
            inflight.popleft().result(timeout=RESULT_S)
    while inflight:
        inflight.popleft().result(timeout=RESULT_S)
    return time.perf_counter() - t0


def reduce_windows(windows) -> dict:
    """The soaks' summary of per-window frames/s: the windows, their mean,
    least and greatest, and their spread, ``ptp / mean`` in percent
    (scripts/soak_server_r4.py:86-89; None for no window)."""
    if not windows:
        return {"windows_fps": [], "mean_fps": None, "min_fps": None, "max_fps": None,
                "spread_pct": None}
    mean = float(np.mean(windows))
    return {"windows_fps": list(windows), "mean_fps": round(mean, 1),
            "min_fps": min(windows), "max_fps": max(windows),
            "spread_pct": round(float(np.ptp(windows) / mean * 100), 2)}


KNEE_CRITERION = "largest depth with p50 <= 3x the depth-1 p50"


def knee(rows):
    """The depth frontier's knee (scripts/bench_chain_depth_frontier.py:
    106-119): the largest depth whose p50 latency stays within 3x the
    first row's (beyond it latency grows with the queue while frames/s
    saturate); None where the first row has no latency."""
    if not rows or not rows[0].get("latency_ms"):
        return None
    base = rows[0]["latency_ms"]["p50"]
    depth = max((r["depth"] for r in rows
                 if r.get("latency_ms") and r["latency_ms"]["p50"] <= 3 * base),
                default=rows[0]["depth"])
    return {"depth": depth, "criterion": KNEE_CRITERION}


def kernel_counts():
    """(K1, K4) launches and replays of ``compile_forward``'s CUDA graph
    so far in this process (0 on the CPU, where the plain versions run
    and nothing is captured).  A replay runs K1 and K4 without their
    wrappers, which count the launches."""
    from fastdepth_tpu_torch.engine import aot
    from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER

    return COUNTER["K1"], COUNTER["K4"], aot.GRAPH_REPLAYS


def launches(before, forwards: int) -> dict:
    """K1's and K4's launches and the graph's replays since ``before``
    (:func:`kernel_counts`) over ``forwards`` forwards."""
    k1, k4, replays = kernel_counts()
    return {"K1": k1 - before[0], "K4": k4 - before[1], "replays": replays - before[2],
            "forwards": int(forwards)}


def forwards_of(stats: dict, chain: bool) -> int:
    """The forwards a server ran, from its ``stats()``: a batch each, or a
    batch-1 forward a frame in chain mode (a window's padded tail never
    runs)."""
    return stats["frames"] if chain else stats["batches"]


def write_json(path: str, obj) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


class NullModel(Model):
    """An identity-cost model: (B, H, W, 3) -> the channel mean (B, H, W,
    1), with no parameters (scripts/soak_server_socket_r5.py:98-107).  A
    server runs its real code around it (wire, queue, packing, copies, the
    stream and event waits); only the model's arithmetic is free."""

    def apply(self, params, x: torch.Tensor, **kw) -> torch.Tensor:
        return x.mean(dim=-1, keepdim=True)

    def fold(self, params):
        return params


def null_model():
    """(NullModel with the flagship's config, its empty params)."""
    from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED

    return NullModel(FASTDEPTH_PRUNED), torch.nn.ModuleDict()
