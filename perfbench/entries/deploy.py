"""Single-frame deploy: one camera, a closed loop over the function
``engine/aot.compile_forward`` returns.

Set-up draws the parameters, compiles the forward at batch 1 (fold,
cast, kernels built, one run), makes a ring of ``ring`` f32 frames in
host memory and runs ``warmup_frames`` frames.  Per frame in the window:
a host frame from the ring is copied to the card, the forward runs and
its prediction is copied back to host memory; the frame's latency is
from handing the frame in to holding the prediction.  The predictions
of ``sample_frames`` frames drawn from the seed among the first
``sample_from``, and of the last, are kept for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program
from perfbench.context import Ctx, Outcome, process_age, setup_note


def run(ctx: Ctx) -> Outcome:
    from fastdepth_tpu_torch.engine.aot import compile_forward

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    ring = wl["ring"]
    h, w = cfg["image_size"]
    marks = [("imports", process_age())]
    sd = program.draw_params(cfg, ctx.seed, dev)
    marks.append(("weights", process_age()))
    model, params = program.load(cfg, sd, dev)
    fn, prepared = compile_forward(model, params, batch_size=1, image_size=(h, w),
                                   dtype=getattr(torch, wl["dtype"]), impl=wl["impl"],
                                   device=dev)
    del params
    marks.append(("program", process_age()))
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed + 1)
    frames = list(torch.rand((ring, 1, h, w, 3), generator=g, device=dev).cpu().unbind(0))
    for i in range(wl["warmup_frames"]):
        fn(prepared, frames[i % ring].to(dev)).cpu()
    picks = set(np.random.default_rng([ctx.seed, 7]).choice(
        wl["sample_from"], size=wl["sample_frames"], replace=False).tolist())
    kept = {}

    def window(seconds, keep):
        lat, i = [], 0
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            pred = fn(prepared, frames[i % ring].to(dev)).cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t)
            if keep and i in picks:
                kept[i] = pred
            i += 1
            if t1 - t0 >= seconds:
                break
        if keep:
            kept[i - 1] = pred
        return np.asarray(lat), t1 - t0

    setup_s = process_age()
    marks.append(("inputs and warm-up", setup_s))
    lat, window_s = window(ctx.seconds, keep=True)
    out = Outcome(end_to_end={"latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                              "setup_s": setup_s},
                  attempted=len(lat), failed=0, samples={}, notes=[setup_note(marks)])
    if ctx.trace:
        from perfbench.trace import windows

        traces = windows(ctx.python_trace, lambda: lambda: {
            "frames": len(window(wl["trace_seconds"], keep=False)[0])})
        out.trace, out.python_trace = traces["trace"], traces.get("python_trace")
    out.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    keys = sorted(kept)
    out.samples = {"name": "pred_rel_l2", "params": sd,
                   "inputs": torch.cat([frames[k % ring] for k in keys]),
                   "outputs": torch.cat([kept[k] for k in keys])}
    out.notes.append(f"{len(lat)} frames in {window_s} s: {len(lat) / window_s} frames/s; "
                     f"latency p50 {np.percentile(lat, 50) * 1e3} ms")
    return out
