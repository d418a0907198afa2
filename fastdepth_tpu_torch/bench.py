"""Benchmark: flagship FastDepth (pruned, BN-folded) 224x224 inference
throughput on one GPU — the port's counterpart of the repo's root
``bench.py``.

    python -m fastdepth_tpu_torch.bench [--device cuda|cpu]

The protocol and the one JSON line are ``bench.py``'s: per row, warm-up
calls then pipelined steady-state throughput (back-to-back calls, one
wait at the end: ``engine/benchmark.time_pipelined``, CUDA events on the
card), the headline, and at batch 1 single-call latency
(``engine/benchmark.time_fn``) beside it.  The rows (:data:`REQUIRED`,
:data:`OPTIONAL`, then the bf16 train step at b128), their tags, dtypes,
batches and result keys, the time budget (``BENCH_BUDGET_S``, default
420 s, after which optional rows are skipped) and the line's keys are
``bench.py``'s.  The last line of stdout is the JSON line; progress goes
to stderr as ``# bench`` lines, the first of them naming the card.

JAX's forwards map to the port's through ``engine/aot._pick_apply``
(:data:`PORT_IMPL`): ``xla`` is the straight forward (``model.apply``),
``opt`` the head-commute forward (``models/fused.apply_fastdepth_opt``),
``pallas`` the fused forward (``apply_fastdepth_fused``: K1 on the five
decoder levels, K4 on the head).  ``bench.py``'s pallas forward is
``apply_fastdepth_fused_hybrid``, a way round the TPU compile helper's
grid limit over the same kernel; its row stays at b32, the TPU's limit,
so that the two lines compare key for key.  f32 rows are true f32 (the
params are cast through ``engine/aot._prepare``, which turns TF32 off);
bf16 rows leave the TF32 flags as they find them.

The line carries ``bench.py``'s roofline ratios on the same condition
(the bf16 ``opt`` b128 row wins), with the card's denominators:
``x_roofline_spec`` over ``engine/roofline.spec_composite_us`` (every
layer's bf16 bound at the H100 data sheet's rates that
``docs/probe_h100_hbm.json`` records, the head at a quarter of its
bytes) and ``x_roofline_measured`` over
``engine/roofline.measured_composite_us`` on the card's measured
ceilings in the same file.  ``vs_baseline`` is against the reference's
TX2 GPU, 5.6 ms a frame (reference README.md:136).

A SIGTERM at any point, the card's set-up included, prints the line with
the rows measured so far and ``"aborted"`` in ``detail``, and exits 124.

``--device cuda`` (the default) needs a card and exits non-zero without
one; ``--device cpu`` times the kernels' plain versions on the CPU, and
its numbers are CPU times, not the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED

METRIC = "224x224 NYUv2 frames/sec/chip"
TX2_GPU_MS = 5.6  # reference README.md:136
# (tag, dtype, impl, batch), bench.py's: the required rows always run
# (headline first, so a kill still leaves the right value), the optional
# ones while the time budget holds
REQUIRED = [
    ("bf16_opt", "bfloat16", "opt", 128),
    ("fp32", "float32", "xla", 128),
    ("fp32", "float32", "xla", 1),
    ("bf16", "bfloat16", "xla", 1),
]
OPTIONAL = [
    ("bf16", "bfloat16", "xla", 128),
    ("bf16_pallas", "bfloat16", "pallas", 32),
    ("bf16", "bfloat16", "xla", 32),
]
PORT_IMPL = {"xla": "xla", "opt": "opt", "pallas": "fused"}
ROOFLINE_ROW = "bf16_opt_b128"  # the row the roofline ratios describe (bench.py:54)
CONFIG = FASTDEPTH_PRUNED
IMAGE_SIZE = 224
SEED = 0
WARMUP, CALLS = 3, 60  # bench.py: 60 calls amortise the fixed submit/sync cost
LATENCY_WARMUP, LATENCY_REPEATS = 2, 10
TRAIN_TAG, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS = "train_bf16", 128, 0.01, 3, 20
BUDGET_S = 420.0  # BENCH_BUDGET_S overrides


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def flagship():
    """(model, folded f32 params on the CPU): :data:`CONFIG` built, its
    seeded ``Model.init`` folded."""
    import torch

    from fastdepth_tpu_torch.models import build

    model = build(CONFIG)
    return model, model.fold(model.init(torch.Generator().manual_seed(SEED)))


def cast(model, params32, dtype, device):
    """One copy of the folded params in ``dtype`` on ``device``, through
    ``engine/aot._prepare`` (in f32 it turns TF32 off: true f32)."""
    from fastdepth_tpu_torch.engine.aot import _prepare

    return _prepare(model, params32, batch_size=1, dtype=dtype, fold_bn=False, impl="xla",
                    device=device)[0]


def row_forward(model, params, impl: str, batch: int):
    """``fn(params, x)``: the forward a row's JAX impl name selects
    (:data:`PORT_IMPL` through ``engine/aot._pick_apply``), under
    inference mode."""
    import torch

    from fastdepth_tpu_torch.engine.aot import _pick_apply

    apply = _pick_apply(model, params, PORT_IMPL[impl], batch)

    def fn(p, x):
        with torch.inference_mode():
            return apply(p, x)
    return fn


def roofline_ratios(best_fps: float, probe_path=None) -> dict:
    """``x_roofline_spec`` and ``x_roofline_measured``: the measured time a
    frame over the spec-peak and the measured-ceiling composites of
    :data:`CONFIG` at :data:`IMAGE_SIZE` from the calibration JSON at
    ``probe_path`` (``docs/probe_h100_hbm.json``); empty where the file is
    absent or malformed (the line must still print)."""
    from fastdepth_tpu_torch.engine.roofline import (
        CEILINGS_PATH,
        measured_composite_us,
        spec_composite_us,
    )

    try:
        with open(probe_path or CEILINGS_PATH) as f:
            probe = json.load(f)
        spec = spec_composite_us(CONFIG, probe, IMAGE_SIZE)
        measured = measured_composite_us(CONFIG, probe, IMAGE_SIZE)
        us = 1e6 / best_fps
        return {"x_roofline_spec": round(us / spec, 2),
                "x_roofline_measured": round(us / measured, 2)}
    except (OSError, ValueError, KeyError, TypeError, ZeroDivisionError):
        return {}


def line(results: dict, best_fps: float, best_cfg, note=None) -> dict:
    """The JSON line of ``bench.py`` for the rows in ``results`` (updated in
    place with ``aborted``, ``best_us_per_frame`` and, where
    :data:`ROOFLINE_ROW` won, the roofline ratios)."""
    if note:
        results["aborted"] = note
    if best_fps:
        results["best_us_per_frame"] = round(1e6 / best_fps, 2)
        if best_cfg == ROOFLINE_ROW:
            results.update(roofline_ratios(best_fps))
    return {
        "metric": METRIC,
        "value": round(best_fps, 1),
        "unit": "fps",
        "vs_baseline": round(best_fps / (1000.0 / TX2_GPU_MS), 2),
        "best_config": best_cfg,
        "detail": results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain versions, CPU times)")
    args = ap.parse_args(argv)
    device = args.device
    results = {}
    best = {"fps": 0.0, "cfg": None}
    emitted = [False]

    def emit(note=None):
        if emitted[0]:
            return
        emitted[0] = True
        print(json.dumps(line(results, best["fps"], best["cfg"], note)), flush=True)

    # registered before torch and the card are touched: a kill at any
    # point, set-up included, still prints the line (with zero rows).
    # os._exit, not sys.exit: a SystemExit raised where the signal lands
    # can be swallowed (a finalizer, a callback out of C++), and the run
    # would go on to exit 0 after the aborted line
    def on_sigterm(signum, frame):
        emit(f"killed by signal {signum} mid-run; partial rows")
        sys.stderr.flush()
        os._exit(124)

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        _run(device, results, best, emit, emitted)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 0


def _run(device: str, results: dict, best: dict, emit, emitted) -> None:
    import torch

    from fastdepth_tpu_torch.engine.benchmark import card_info, sync, time_fn, time_pipelined

    if device == "cuda":
        if not torch.cuda.is_available():
            emitted[0] = True  # a refusal measures nothing: no line
            raise SystemExit("bench: --device cuda: no CUDA device is available (pass "
                             "--device cpu to time the plain versions on the CPU)")
        card = card_info()
        log(f"# bench card: {card['nvidia_smi']} (x{card['count']}), torch {card['torch']}, "
            f"CUDA {card['cuda']}")
        from fastdepth_tpu_torch.ops.cuda import _build

        _build.load()
    else:
        log(f"# bench device: cpu, torch {torch.__version__} (the kernels' plain versions; "
            "CPU times, not the card's)")

    model, params32 = flagship()
    rng = np.random.RandomState(SEED)

    def record(tag, batch, fn, params, x, latency_too):
        log(f"# bench {tag}_b{batch} ...")
        t0 = time.time()
        try:
            stats = time_pipelined(fn, (params, x), warmup=WARMUP, calls=CALLS, device=device)
        except Exception as e:  # a failing row is reported in the line
            results[f"{tag}_b{batch}"] = f"error: {type(e).__name__}: {e}"[:120]
            return
        fps = batch / stats["mean_s"]
        # the row is in the line before its progress line says so: a kill
        # from then on keeps it
        results[f"{tag}_b{batch}_fps"] = round(fps, 1)
        if fps > best["fps"]:
            best["fps"], best["cfg"] = fps, f"{tag}_b{batch}"
        log(f"#   {tag}_b{batch}: {fps:.1f} fps ({time.time() - t0:.0f}s incl. warm-up)")
        if latency_too:
            lat = time_fn(fn, (params, x), warmup=LATENCY_WARMUP, repeats=LATENCY_REPEATS,
                          device=device)
            results[f"{tag}_b{batch}_latency_ms"] = round(lat["median_s"] * 1e3, 3)

    budget_s = float(os.environ.get("BENCH_BUDGET_S", BUDGET_S))
    t_start = time.time()
    by_dtype = {}
    for required, (tag, dtype_name, impl, batch) in (
            [(True, c) for c in REQUIRED] + [(False, c) for c in OPTIONAL]):
        if not required and results and time.time() - t_start > budget_s:
            results[f"skipped_{tag}_b{batch}"] = "over time budget"
            continue
        dtype = getattr(torch, dtype_name)
        if dtype not in by_dtype:
            by_dtype[dtype] = cast(model, params32, dtype, device)
        params = by_dtype[dtype]
        x = torch.from_numpy(rng.rand(batch, IMAGE_SIZE, IMAGE_SIZE, 3)).to(device, dtype)
        record(tag, batch, row_forward(model, params, impl, batch), params, x,
               latency_too=(batch == 1))

    # the bf16 train step (forward, backward, SGD update, statistics
    # merge) at b128: the port's Trainer, host clock ending in a wait
    train_key = f"{TRAIN_TAG}_b{TRAIN_BATCH}"
    if time.time() - t_start <= budget_s:
        log(f"# bench {train_key} ...")
        try:
            from fastdepth_tpu_torch.config import TrainConfig
            from fastdepth_tpu_torch.train import Trainer

            trainer = Trainer(model, model.init(torch.Generator().manual_seed(SEED)),
                              TrainConfig(lr=TRAIN_LR), compute_dtype=torch.bfloat16,
                              device=device)
            shape = (TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE)
            rgb = torch.from_numpy(rng.rand(*shape, 3).astype(np.float32)).to(device)
            depth = torch.from_numpy((rng.rand(*shape, 1) * 5 + 0.5).astype(np.float32)).to(device)
            for _ in range(TRAIN_WARMUP):
                trainer.state, loss = trainer._step(trainer.state, rgb, depth, TRAIN_LR)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                trainer.state, loss = trainer._step(trainer.state, rgb, depth, TRAIN_LR)
            sync(device)
            tfps = TRAIN_BATCH * TRAIN_STEPS / (time.perf_counter() - t0)
            results[f"{train_key}_fps"] = round(tfps, 1)
            log(f"#   {train_key}: {tfps:.1f} train-fps")
        except Exception as e:  # never let the train row sink the line
            results[train_key] = f"error: {type(e).__name__}: {e}"[:120]
    else:
        results[f"skipped_{train_key}"] = "over time budget"
    emit()


if __name__ == "__main__":
    sys.exit(main())
