"""Batch evaluation: a closed loop over ``Evaluator.__call__``.

Set-up draws the parameters, builds the port's ``Evaluator`` (fold,
cast to the cell's dtype, the forward ``impl`` picks), and puts ``ring``
distinct batches on the device: uint8 RGB frames and f32 depth in
0.5-10 m.  Then it runs ``warmup_steps`` steps.  The window enqueues one
step after another over the ring, each step's metric rows fetched after
the next step is enqueued (one step in flight, as ``validate()`` keeps
it), until ``seconds`` have passed; the last step is waited for.  The
outputs of ``sample_steps`` steps drawn from the seed among the first
``sample_from``, and of the last step, are kept for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program
from perfbench.context import Ctx, Outcome, process_age, setup_note
from perfbench.reference.common import METRIC_FIELDS


def run(ctx: Ctx) -> Outcome:
    from fastdepth_tpu_torch import metrics as M
    from fastdepth_tpu_torch.engine.evaluator import Evaluator

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    b, ring = wl["batch"], wl["ring"]
    h, w = cfg["image_size"]
    marks = [("imports", process_age())]
    sd = program.draw_params(cfg, ctx.seed, dev)
    marks.append(("weights", process_age()))
    model, params = program.load(cfg, sd, dev)
    ev = Evaluator(model, params, batch_size=b, dtype=getattr(torch, wl["dtype"]),
                   impl=wl["impl"], device=dev)
    del params
    marks.append(("program", process_age()))
    g = torch.Generator(device=dev)
    g.manual_seed(ctx.seed + 1)
    rgb = torch.randint(0, 256, (ring, b, h, w, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    depth = torch.rand((ring, b, h, w, 1), generator=g, device=dev) * 9.5 + 0.5
    for i in range(wl["warmup_steps"]):
        ev(rgb[i % ring], depth[i % ring])[1].cpu()
    picks = set(np.random.default_rng([ctx.seed, 7]).choice(
        wl["sample_from"], size=wl["sample_steps"], replace=False).tolist())
    kept = {}

    def window(seconds, keep):
        steps, fetch = 0, None
        t0 = time.perf_counter()
        while True:
            r = steps % ring
            pred, rows = ev(rgb[r], depth[r])
            if keep and steps in picks:
                kept[steps] = (r, pred, rows)
            if fetch is not None:
                fetch.cpu()
            fetch, steps = rows, steps + 1
            if time.perf_counter() - t0 >= seconds:
                break
        fetch.cpu()
        if keep:
            kept[steps - 1] = (r, pred, rows)
        return steps, time.perf_counter() - t0

    setup_s = process_age()
    marks.append(("inputs and warm-up", setup_s))
    steps, window_s = window(ctx.seconds, keep=True)
    out = Outcome(end_to_end={"frames_per_s": steps * b / window_s, "setup_s": setup_s},
                  attempted=steps * b, failed=0, samples={}, notes=[setup_note(marks)])
    if ctx.trace:
        from perfbench.trace import windows

        def go():
            n, _ = window(wl["trace_seconds"], keep=False)
            return {"steps": n, "frames": n * b}

        traces = windows(ctx.python_trace, lambda: go)
        out.trace, out.python_trace = traces["trace"], traces.get("python_trace")
    out.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    order = [M.METRIC_FIELDS.index(f) for f in METRIC_FIELDS]
    slots = [kept[k][0] for k in sorted(kept)]
    out.samples = {
        "name": "pred_rel_l2", "params": sd, "inputs": rgb[slots].flatten(0, 1),
        "depth": depth[slots].flatten(0, 1),
        "outputs": torch.cat([kept[k][1] for k in sorted(kept)]),
        "metric_rows": torch.cat([kept[k][2][order] for k in sorted(kept)], dim=1)}
    return out
