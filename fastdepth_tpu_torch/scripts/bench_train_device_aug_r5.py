"""The train step with the augmentation on the card against the plain
step, in both lookup forms — the port's counterpart of
``scripts/bench_train_device_aug_r5.py``.

Rows, frames/s of the whole bf16 train step (forward, backward, SGD with
momentum) of the pruned flagship at random weights, on batches staged on
the card once and stepped again and again:

  plain_train_fps                  ``make_train_step``'s step on (rgb224,
                                   depth224): the host made the items
  device_augment_dot_train_fps     the same step after ``probe_r5_device_gathers.
                                   augment_dot`` (JAX's ``lut_impl="dot"``) on raw
                                   480x640 frames, gather maps and jitter grids
  device_augment_gather_train_fps  ``make_train_step(device_augment=True)``'s
                                   step, the port's: ``data/device_aug.
                                   apply_train_augment``, then the same step

All three steps come from ``make_train_step``, each on its own copy of
the weights; the dot step wraps the plain one as the port's
device-augment step does (the augmented batch cast to the masters'
dtype), as the script's ``_GatherTrainer`` wraps JAX's.  A row is 3
warm-up steps, then ``--calls`` steps timed as one span
(``engine/benchmark.time_pipelined``, CUDA events on the card).  The rows
are timed ``--repeats`` rounds, the order reversed every other round
(plain, gather, dot; dot, gather, plain), so that plain and gather run
next to each other in both orders; ``runs`` holds every round's rate and
``rows`` each row's median.  ``aug_cost_pct_<form>`` is the share of the
plain rate the augmentation takes, ``100 * (1 - aug / plain)`` from the
medians, and ``aug_cost_pct_runs`` the same share round by round, against
that round's plain rate: a cost smaller than their spread is not resolved.

    python -m fastdepth_tpu_torch.scripts.bench_train_device_aug_r5 [--batch 128]
        [--calls 20] [--repeats 5] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics

import numpy as np
import torch

from fastdepth_tpu_torch.scripts import _serving as S
from fastdepth_tpu_torch.scripts.probe_r5_device_gathers import RAW_HW, augment_dot

LR = 0.01
WARMUP = 3
FORMS = ("dot", "gather")
ORDER = ("plain_train_fps", "device_augment_gather_train_fps", "device_augment_dot_train_fps")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    S.add_common(p, "bench_train_device_aug_h100.json")
    return p.parse_args(argv)


def make_batches(b: int, out_size=(224, 224), seed: int = 0):
    """The script's two staged batches from ``RandomState(seed)`` in its
    order (scripts/bench_train_device_aug_r5.py:72-111): the plain step's
    ``(rgb, depth)`` at ``out_size`` and the device-augment step's six raw
    arrays, whose maps make ``out_size`` items."""
    from fastdepth_tpu_torch.data import transforms as T

    oh, ow = out_size
    n_out, n_raw = oh * ow, RAW_HW[0] * RAW_HW[1]
    rng = np.random.RandomState(seed)
    plain = (rng.rand(b, oh, ow, 3).astype(np.float32),
             (rng.rand(b, oh, ow, 1) * 5 + 0.5).astype(np.float32))
    tables = np.stack([np.stack([T.blend_grid(f) for f in rng.uniform(0.6, 1.4, 3)])
                       for _ in range(b)])
    raw = (rng.randint(0, 256, (b, *RAW_HW, 3)).astype(np.uint8),
           (rng.rand(b, *RAW_HW) * 5 + 0.5).astype(np.float32),
           np.where(rng.rand(b, n_out) < 0.02, -1,
                    rng.randint(0, n_raw, (b, n_out))).astype(np.int32),
           (rng.rand(b) * 0.5 + 1.0).astype(np.float32),
           tables,
           np.tile(np.array([1, 2, 3], np.int32), (b, 1)))
    return plain, raw


def make_steps(model, cfg, compute_dtype=torch.bfloat16) -> dict:
    """``{row: step}``: the plain step and the two device-augment steps,
    all from ``make_train_step``."""
    from fastdepth_tpu_torch.train.trainer import make_train_step

    plain = make_train_step(model, cfg, compute_dtype=compute_dtype)
    out_size = tuple(model.config.output_size)

    def dot(state, rgb_raw, depth_raw, flat, scale, tables, kinds, lr):
        rgb, depth = augment_dot(rgb_raw, depth_raw, flat, scale, tables, kinds,
                                 out_size=out_size)
        dtype = state.flat.params.dtype
        return plain(state, rgb.to(dtype), depth.to(dtype), lr)

    return {"plain_train_fps": plain, "device_augment_dot_train_fps": dot,
            "device_augment_gather_train_fps": make_train_step(
                model, cfg, compute_dtype=compute_dtype, device_augment=True)}


def train_fps(step, state, args, calls: int, device: str) -> float:
    """Frames/s of ``step`` on ``state`` (updated in place) over the staged
    ``args``: :data:`WARMUP` steps, then ``calls`` timed as one span."""
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    def one():
        step(state, *args, LR)

    mean_s = time_pipelined(one, warmup=WARMUP, calls=calls, device=device)["mean_s"]
    return args[0].shape[0] / mean_s


def main(argv=None) -> dict:
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.train import sgd_init

    args = parse_args(argv)
    card = S.check_device(args.device)
    b = args.batch
    model, params = S.flagship()
    results = {"batch": b, "calls": args.calls, "dtype": "bf16", "repeats": args.repeats,
               "rows": {}, "runs": {}}
    plain, raw = make_batches(b, tuple(model.config.output_size))
    plain, raw = (tuple(torch.from_numpy(a).to(args.device) for a in arrays)
                  for arrays in (plain, raw))
    steps = make_steps(model, TrainConfig(lr=LR))
    batches = {tag: plain if tag == "plain_train_fps" else raw for tag in steps}
    states = {tag: sgd_init(copy.deepcopy(params).to(args.device)) for tag in steps}
    runs = {tag: [] for tag in steps}
    for r in range(args.repeats):
        for tag in (ORDER if r % 2 == 0 else ORDER[::-1]):
            runs[tag].append(round(train_fps(steps[tag], states[tag], batches[tag], args.calls,
                                             args.device), 1))
            print(json.dumps({"round": r, tag: runs[tag][-1]}), flush=True)
    results["runs"] = runs
    results["rows"] = rows = {tag: statistics.median(v) for tag, v in runs.items()}
    for form in FORMS:
        aug = f"device_augment_{form}_train_fps"
        results[f"aug_cost_pct_{form}"] = round(
            100.0 * (1 - rows[aug] / rows["plain_train_fps"]), 2)
        results.setdefault("aug_cost_pct_runs", {})[form] = [
            round(100.0 * (1 - a / p), 2) for a, p in zip(runs[aug], runs["plain_train_fps"])]
    print(json.dumps({k: v for k, v in results.items() if "pct" in k}), flush=True)
    results["card"] = card
    S.write_json(args.out, results)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
