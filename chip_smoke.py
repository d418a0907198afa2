#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and makes f32 true f32 (engine.aot.strict_f32:
   TF32 off);
2. build: compiles every kernel of the port from fastdepth_tpu_torch/csrc;
3. kernels: each kernel (K1-K4) against its plain PyTorch version, on
   the card, at the shapes the flagship's paths give it (f32 and bf16;
   K1 at the eval path's batch 8 and the deploy path's batch 1, whose
   launch geometries differ),
   with the launch geometry each kernel's host function picks per level,
   with both device times (CUDA events around a CUDA graph of the calls,
   cycling through enough copies of the operands that the 50 MB L2 holds
   none of them) and, beside them, CUDA-event times of pipelined calls
   (which count the host's launch time when a call is shorter than it),
   and each call's bound (engine/benchmark.bound_us: bytes or operations
   at the H100's published rates); then K7, the conv epilogue, over
   every epilogue one forward of each benchmark path gives it (the
   flagship's 27 encoder convs at b128 bf16 and b1 f32, ResNet-50-UpProj's
   70 at b128 bf16, DA-V2's 29 at b64 bf16), their operands recorded
   from the forward: bit for bit its plain version, and the whole set's
   device time beside its byte bound, the plain version's and the
   library's (ATen's in-place bias add_, then the residual add and the
   activation, the ops K7 replaces); then K8, the metric sums, at the
   benchmark cells' metric shapes (b128 at 224x224, b64 at 518x518, one
   224x224 pair) on seeded maps with zeros, negative predictions, an
   all-zero target and an image with no valid pixel: its counts and
   delta sums equal to its plain version's, its float sums within 1e-5
   relative, two launches the same bits, and its device time beside its
   byte bound and the plain version's;
4. eval path: the committed trained weights (docs/rehearsal_model_r5.npz)
   -> build -> fold -> Evaluator(impl='auto') -> validate() over seeded
   raw 480x640 frames put through the shared val pipeline, at f32 and
   bf16; counts K1's and K4's launches on that run, and holds the fused
   forward against the port's straight (plain PyTorch) forward;
5. v2 / v3 forwards: the same weights through K2 or K3 and K4 at batch
   8, held against the straight forward, with their launch counts;
6. deploy path: cli.deploy.main on a seeded 224x224 rgb npy, f32 and
   --bf16, with randomized-input timing; its saved prediction against the
   straight forward, and K1's and K4's launches on every call (a call
   that replays compile_forward's CUDA graph counts its launches in
   engine.aot.GRAPH_REPLAYS, every call after the compile replays); then the
   deploy CLI in f32 in a fresh process, whose TF32 flags start at
   PyTorch's defaults: it must turn TF32 off and its prediction must
   agree with the straight forward (TF32 off) within 1e-3;
7. serve path: the serving daemon (engine/server.py) on the committed
   weights at 224x224, each server behind a unix socket: f32 at batch 8
   (64 frames through request_stream at depth 32, 8 lone requests), uint8
   in and f16 out, chain mode with a window of 4, and bf16, every answer
   held against the straight forward (bf16: the port's bf16 fused
   forward), K1's and K4's launches counted over each server's run;
   frames/s, the stats' p50/p99 and occupancy, and a lone frame's round
   trip; and the uint8 normalisation bit for bit on all 256 values (the
   eval path checks the Evaluator's uint8 path the same way);
8. tuned dispatch: cli.autotune on the four released models at a reduced
   call count (the plain cuDNN stage 'xla' against K1 'pallas', level by
   level; each record printed as one JSON line, every level with a
   winner at both dtypes); Evaluator(impl='mixed') on the committed
   weights at b8 with the flagship's tuned record, a hand-mixed map and
   all plain stages: K1 launched once per 'pallas' level and K4 once a
   forward, f32 within 1e-3 of the fused forward, metric rows, eval step
   times in turns with the fused one (and at b128, where the device
   binds, for the hand-mixed and all-plain maps); cli.deploy --impl mixed --tuning
   b1 f32 in a fresh process; a mixed InferenceServer b8 against the
   mixed Evaluator's forward;
9. bundle: the deploy bundle (engine/aot.save_bundle / load_bundle:
   torch.export with K1 and K4 as the custom ops fastdepth::
   fused_decoder_stage and fastdepth::pointwise_head) at 224x224 b1:
   cli.deploy --model --save-bundle on the trained flagship in f32, bf16
   and --impl mixed with the committed tuning/h100 record, then the three
   bundles through cli.deploy --load-bundle in one fresh process (K1
   launched once a K1 level and K4 once a call in that process, TF32 off
   after the f32 load, each loaded prediction against the saving run's:
   f32 within 1e-5, bf16 within 2^-7 * max|pred|); the hand-mixed map's
   bundle and resnet50-upproj's (full width, random weights: no K1 or
   K4) against compile_forward; the export and load seconds, deploy b1
   medians from the bundle and from the checkpoint in turns, the host
   cost of a call through each op against its implementation called
   directly, and torch.library.opcheck of both ops on CUDA tensors;
10. zoo: the rest of the model zoo at 224x224 with seeded random weights
   (Model.init's convs, drawn BatchNorm statistics, a non-negative last
   conv; no trained zoo weights exist): resnet50-upproj at full
   width through validate() b8 f32 and bf16, cli.deploy.main b1 f32,
   one b8 f32 train step on the card against the CPU's (loss, parameters
   and running statistics; the momentum against an f64 CPU step), four
   steps of cli.train's epoch loop b8 f32, and a b8 f32 server over a
   unix socket driven as the serve phase drives the flagship's (K1 and
   K4 launched 0 times), each f32 output within 1e-3 * max(1, max|cpu|)
   of the port's straight forward on the CPU (TF32 off), bf16 within a
   relative L2 error of 2e-2 of the card's f32; frames/s, deploy ms,
   train step ms (b8 f32 and bf16), serving frames/s and p50/p99, peak
   memory and the largest kernels of one b8 step; mobilenet-nnconv5
   (BASELINE config #2) through validate() b8 f32 on the head-commute
   forward (K1 and K4 launched 0 times); then every registry decoder on
   a tiny MobileNet encoder and ResNet-18/34 (skip add, concat), -50
   (bottleneck_skips add, concat), -101 and -152, one b2 f32 forward each
   through compile_forward on the card against the CPU, same bound;
11. train path: the committed weights fine-tuned at 224x224 through the
   port's train item path (seeded raw frames, the real augmentations):
   one f32 step on the card against the CPU (with an f64 CPU step as the
   momentum's reference), the loss falling over 10 steps, a checkpoint
   round trip, remat and accumulation, cli.train's epoch loop in f32 and
   bf16 with K1's and K4's launches in its validation, and the step time
   at b8 and b128 in f32 and bf16 with the peak memory;
12. input: the input pipeline's on-card half on the committed weights
   over seeded raw frames: device augmentation (data/device_aug.py), and
   its dot form (scripts/probe_r5_device_gathers.augment_dot), bit for
   bit against the host's train items and its own CPU run, the
   device-augment train step bit for bit against the host-item step,
   cli.train's epoch loop with --device-augment, device preprocessing
   (Evaluator(val_pipeline=...)) against the host path with K1's and
   K4's launches, metrics.evaluate, the pinned staging ring's wait; and
   the times: cli.benchmark's train_run (b8, b128; f32, bf16; host against
   device augmentation) and eval_run (b8 f32, host against device
   preprocessing), the b128 copy and augmentation against its bound, and
   engine/benchmark.throughput_sweep;
13. mesh: data parallelism (parallel/) at world size 1 over NCCL, every
   collective issued: the train step with the mesh against the step
   without (b8 f32 and accum_steps 2 within the train phase's bounds, b8
   bf16 loss within rtol 3e-3), Evaluator(mesh) against Evaluator(mesh=
   None) (metric rows 0 apart, K1 launched 5 times and K4 once a
   forward), the mesh's cost (train step b8 f32 and b128 bf16, eval step
   b8 f32, in turns with the no-mesh ones; collectives a step),
   cli.train / cli.evaluate --mesh-devices 1 against their runs without a
   mesh, --mesh-devices 2 refused up front, and two gloo ranks on the
   CPU (parallel/dryrun.py);
14. space: the space mesh axis and serving over a mesh (parallel/
   spatial.py): K1's row-window mode against its plain version at every
   (tile, window) that S = 2, 4, 8 give at 224x224 on the pruned
   flagship's five levels (b8, f32 and bf16), the whole-image window bit
   for bit the call without one, rank 1's window times beside the whole
   level's, each rank's MAC share under the partition's replicated
   levels, and K1's whole-image five-level f32 b8 time within 5% of its
   time before the window; every rank's tile of the zoo's 31 sharded-op
   cases at S = 2 and 4 through the card's convolutions, in this process
   with the halo exchange replaced by slices of the whole input
   (parallel/halo_check.py), against the unsharded op within 1e-4 *
   max(1, max|unsharded|); world-1 make_mesh(1, 'space') and make_mesh_2d(1, 1) over NCCL
   (Evaluator metric rows 0 apart from no mesh, K1 5 and K4 1 launches a
   forward, the eval step b8 f32 with and without them, a mesh
   InferenceServer's answers 0 apart from the server without one and the
   frames/s of both); the space dryrun over gloo ranks on the CPU
   (parallel/dryrun.py --space: two ranks at S = 2 on the trained
   flagship at 224x224 b1, four on a 2 x 2 mesh through the Evaluator);
   then the rest of the zoo on the space axis, on resnet50-upproj at
   224x224, full width, random weights: each rank's MAC share at S = 2,
   4, 8, the world-1 meshes' Evaluator b8 (metric rows 0 apart from no
   mesh, K1 and K4 launched 0 times) and forward (bit for bit), the eval
   step b8 f32 with and without them in turns, a mesh InferenceServer
   whose answers are 0 apart from the server without one, and the space
   dryrun's halo rules on it (--model resnet50-upproj: S = 2 within 1e-4
   of the output's scale, the 2 x 2 Evaluator within 1e-5 relative);
15. probes: every tag of the probe catalogue (engine/probes.py, the
   scripts' Pallas probes) runs its kernel (K5, K6, or K3) once, with
   K5's and K6's launches counted on that run; then the launch floor
   (the least a call costs in the same timer), each kernel against its
   plain version with both times, its bound and, where one PyTorch call
   computes the same function, that call's time and the kernel's ratio
   to it (with the CUDA kernels K6's taps and up_only yardsticks run
   as); K5's copy sweep (dma_copy) and K6's scale rows (compute_sweep),
   each checked against its plain version;
16. tools: engine/calibrate (reduced call count) measures the card's
   ceilings, and cli.profile --mode prefix --batch 128 profiles the
   pruned flagship on them; the summed roofline bounds must not exceed
   the measured full forward; cli.fidelity's f32 against bf16 rows on
   the committed weights over seeded frames in memory, cli.frontier at a
   reduced sweep (the flagship with its 'mixed' row from the committed
   tuning/h100.* record, and mobilenet-nnconv5; b1, b32; both dtypes),
   and cli.visualize's PNGs;
17. graft: fastdepth_tpu_torch/graft_entry.py (the root
   __graft_entry__.py's entry points): entry()'s forward on the card
   against the CPU's within 1e-3 * max(1, max|cpu|), dryrun_multichip(1)
   over NCCL at world 1, and dryrun_multichip(4, device='cpu') over four
   gloo ranks on the CPU (a 1 x 4 (data, space) mesh included);
18. scripts: every module of fastdepth_tpu_torch/scripts/ (the port's
   counterparts of the measurement scripts) through its main at reduced
   length (soaks of 0.25 min, 512 frames a chain case, depths 1, 8, 32, a
   5-step train sweep, 64 host items, a 2-epoch rehearsal over 64 items,
   the roofline, the frontier PNG, the halo analysis, the b1 ordering,
   the two device-augment probes at b8 and the train bench at b32), each
   JSON checked for its script's keys; K1 launched 5 times and K4
   once a forward on the serving modules and the fused b1 rows; the soak
   server's and the chain servers' first answers against the bf16 fused
   forward of the same frame within 2^-7 + 2^-10 of its scale;
19. prints each phase's seconds, the kernels' JSON line, then the
   result line.

Nothing here, and nothing of the port it drives, imports JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import cProfile
import ctypes
import io
import itertools
import json
import os
import pstats
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "docs", "rehearsal_model_r5.npz")
BATCH = 8
DEPLOY_BATCH = 1  # the deploy runner's forward
FLAGSHIP_BATCH = 128  # the benchmark's flagship cell, fastdepth.batch-b128
E2E_BATCHES = 4
STAGES_PER_FORWARD = 5
# compile_forward's runs of the forward on CUDA beyond its warm run: the
# side-stream warm-up and the capture of its CUDA graph
CAPTURE_RUNS = 2
# K7 launches a forward, one a folded conv (ops/cuda/epilogue.py): the
# flagship family's encoder (its stem, 13 depthwise and 13 pointwise
# convs) whatever runs its decoder, and ResNet-50-UpProj's 70
EPILOGUES_PER_FORWARD = 27
ZOO_EPILOGUES = 70

DEPLOY_WARMUP, DEPLOY_RUN = 10, 50
SERVE_FRAMES, SERVE_DEPTH, SERVE_LONE, SERVE_TIMED = 64, 32, 8, 2  # timed: extra streams
SERVE_CHAIN = 4  # the chain server's window
TRAIN_ITEMS, VAL_ITEMS, TRAIN_EPOCHS = 4 * BATCH, 2 * BATCH, 2  # 4 steps an epoch
TRAIN_LR = 1e-3
TRAIN_BIG_BATCH = 128
# the input phase: train items for the b8 and the b128 streaming runs
# (12 and 3 steps a pass), val items for the eval runs (16 batches of 8),
# loader threads
INPUT_TRAIN_ITEMS = {BATCH: 12 * BATCH, TRAIN_BIG_BATCH: 4 * TRAIN_BIG_BATCH}
INPUT_VAL_ITEMS = 16 * BATCH
INPUT_WORKERS = 8
PROBE_CALLS = 10
CALIBRATE_CALLS = 3
PROFILE_CALLS = 5
OUTPUT_HW = (224, 224)

# (H=W, C) of the 1x1 head K4 runs: the pruned flagship's, then the unpruned
HEADS = [("pruned", 224, 16), ("unpruned", 224, 32)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase() -> dict:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the port on the GPU "
             "and has no CPU fallback")
    from fastdepth_tpu_torch.engine.benchmark import card_info

    card = card_info()  # runs nvidia-smi; raises if it fails
    print(card["nvidia_smi"])
    from fastdepth_tpu_torch.engine.aot import strict_f32

    strict_f32()
    print(f"device: {card['name']} x{card['count']}, torch {card['torch']}, CUDA "
          f"{card['cuda']}; TF32 off for cuDNN convolutions and matmuls (f32 phases are "
          "true f32)")
    return card


def build_phase() -> None:
    from fastdepth_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    print(f"build: {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    # ptxas -v, per source: kernels, register range, spills
    per_src = {}
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\d+_GLOBAL__N__\w+?_\d+_(\w+?)_cu_", line)
        if m:
            kernel = per_src.setdefault(m.group(1), {"kernels": 0, "regs": [], "spill": 0})
            kernel["kernels"] += 1
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel is not None:
            kernel["spill"] = max(kernel["spill"], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            kernel["regs"].append(int(m.group(1)))
    for src, k in sorted(per_src.items()):
        print(f"  ptxas {src}.cu: {k['kernels']} kernels, {min(k['regs'])}-{max(k['regs'])} "
              f"registers, largest spill {k['spill']} bytes")


def _median_ms(fn, args, repeats: int = 5, calls: int = 20) -> float:
    """Per-call time of a step or forward: the median over ``repeats``
    runs of ``calls`` pipelined calls, each run timed with CUDA events
    (host launch time included where the device waits for it)."""
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    return float(np.median([time_pipelined(fn, args, calls=calls)["mean_s"]
                            for _ in range(repeats)])) * 1e3


def _head_sets(n, h, c, dtype, copies, seed=1):
    """``copies`` seeded operand sets of the 1x1 head on the card: distinct
    channels_last inputs, the weight and bias shared."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(c, generator=gen, device="cuda") * c ** -0.5).to(dtype)
    b = torch.full((1,), 0.1, device="cuda").to(dtype)
    return [(torch.randn(n, c, h, h, generator=gen, device="cuda").to(dtype)
             .contiguous(memory_format=torch.channels_last), w, b) for _ in range(copies)]


def kernel_phase() -> dict:
    """K1-K3 at every decoder level of the flagship (and the unpruned
    model's first), each at the images per block its forward gives that
    level, at the eval path's batch; K1 also at the flagship cell's batch
    128 and the deploy path's batch 1, since its launch geometry
    (threads, split-C groups, C chunk) follows the batch; K4 at the heads
    at the eval path's batch and the flagship cell's.  Each is held
    against its plain version (``engine.benchmark.tolerance``) and timed
    with the L2 cold; K1-K3 through ``cli.bench_decoder.level_row``.
    Returns per kernel: the worst f32 error, and the f32 times and bound
    summed over the pruned flagship's five levels at batch 8 (K4: its
    head), kernel and plain."""
    from fastdepth_tpu_torch.cli.bench_decoder import LEVELS, format_geometry, geometry, level_row
    from fastdepth_tpu_torch.engine.benchmark import bound_us, cold_copies, compare_and_time
    from fastdepth_tpu_torch.models import fused as F
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3
    from fastdepth_tpu_torch.ops.cuda import head as K4

    stage_kernels = [
        ("K1", K1.fused_decoder_stage, {}, (BATCH, FLAGSHIP_BATCH, DEPLOY_BATCH)),
        ("K2", K2.fused_decoder_stage_hwbc, F.V2_BLOCK_BATCHES, (BATCH,)),
        ("K3", K3.fused_decoder_stage_v3, F.V3_BLOCK_BATCHES, (BATCH,)),
    ]
    keys = ("ms", "plain_ms", "events_ms", "plain_events_ms", "bound_ms")
    out = {k: {"max_abs_err": 0.0, **{key: 0.0 for key in keys}, "bound_terms": {},
               "library_ms": None, "rows": []} for k in ("K1", "K2", "K3", "K4")}

    def record(label, r, summed, **shape):
        row = out[label]
        if not r["ok"]:
            fail(f"{label} disagrees with its plain version at {shape}: max|diff| "
                 f"{r['max_abs_err']} > {r['tol']}")
        ms = {"ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
              "events_ms": r["events_us"] / 1e3, "plain_events_ms": r["plain_events_us"] / 1e3,
              "bound_ms": r["bound_us"] / 1e3}
        row["rows"].append({**shape, **ms, "bound_by": r["bound_by"],
                            "max_abs_err": r["max_abs_err"], "tol": r["tol"]})
        where = (f"{shape['dtype']} b{shape['batch']} {shape['model']} {shape['H']}x{shape['H']} "
                 + (f"{shape['C']}->{shape['Cout']}{' +skip' if shape['skip'] else ''}"
                    if "Cout" in shape else f"head {shape['C']}->1")
                 + (f" block_batch {shape['block_batch']}" if "block_batch" in shape else ""))
        print(f"{label} {where}: max|diff| {r['max_abs_err']:.3e} (bound {r['tol']:.3e}), "
              f"device {label} {ms['ms']:.4f} ms, plain {ms['plain_ms']:.4f} ms, bound "
              f"{ms['bound_ms']:.4f} ms ({r['bound_by']}); events {label} "
              f"{ms['events_ms']:.4f} ms, plain {ms['plain_events_ms']:.4f} ms")
        if shape["dtype"] == "f32":
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            if summed:
                for key in keys:
                    row[key] += ms[key]
                row["bound_terms"][r["bound_by"]] = (row["bound_terms"].get(r["bound_by"], 0.0)
                                                     + r["bound_us"])
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, fn, bbs, batches in stage_kernels:
            for level, h, c, cout, skip in LEVELS:
                which, index = level[:-1], int(level[-1])
                kwargs = {"block_batch": bbs[index]} if bbs else {}
                for n in batches:
                    print(f"{label} {name} b{n} {level} launch: "
                          + format_geometry(geometry(label, n, h, c, cout, name,
                                                     kwargs.get("block_batch"))))
                    r = level_row(level, n, h, c, cout, skip, name, kernel=(label, fn), **kwargs)
                    record(label, r, which == "pruned" and n == BATCH, dtype=name, batch=n,
                           model=which, H=h, C=c, Cout=cout, skip=skip, **kwargs)
        for (which, h, c), n in itertools.product(HEADS, (BATCH, FLAGSHIP_BATCH)):
            elem = torch.finfo(dtype).bits // 8
            px = n * h * h
            sets = _head_sets(n, h, c, dtype, cold_copies(elem * px * (c + 1)))
            r = compare_and_time(K4.pointwise_head, K4.pointwise_head_reference, sets,
                                 counter="K4")
            r["bound_us"], r["bound_by"] = bound_us(elem * (px * (c + 1) + c + 1),
                                                    2 * px * c + 2 * px)
            record("K4", r, which == "pruned" and n == BATCH, dtype=name, batch=n, model=which,
                   H=h, C=c)
    for label, row in out.items():
        row["bound_by"] = max(row.pop("bound_terms").items(), key=lambda kv: kv[1])[0]
        print(f"{label} f32 b{BATCH} sum over the pruned flagship's "
              f"{'head' if label == 'K4' else 'five levels'}: device {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); events {row['events_ms']:.4f} ms, plain "
              f"{row['plain_events_ms']:.4f} ms")
    out["K7"] = epilogue_rows()
    out["K8"] = metric_sums_rows()
    return out


# the benchmark's paths whose epilogues K7's row checks and times:
# (configuration, batch, dtype); the first is the kernel table's
EPILOGUE_MODELS = [("fastdepth-pruned-224", 128, torch.bfloat16),
                   ("resnet50-upproj-224", 128, torch.bfloat16),
                   ("depth-anything-v2-vitl-518", 64, torch.bfloat16),
                   ("fastdepth-pruned-224", 1, torch.float32)]


def _recorded_epilogues(name: str, batch: int, dtype: torch.dtype) -> list:
    """(y, b, residual, act) of every epilogue one forward in ``dtype`` of
    the benchmark's configuration ``name`` (its seeded weights) gives K7,
    each ``y`` a copy taken before K7 wrote it."""
    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.ops.cuda import epilogue as K7
    from perfbench import harness, program

    cfg = harness.config(name)
    model, params = program.load(cfg, program.draw_params(cfg, 2 ** 31 + 7, "cuda"), "cuda")
    params, apply = _prepare(model, params, batch_size=batch, dtype=dtype,
                             fold_bn=True, impl="auto", device="cuda")
    ops, launch = [], K7.launch

    def record(y, b, residual, act):
        ops.append((y.clone(), b, residual, act))
        return launch(y, b, residual, act)

    x = torch.rand((batch, *cfg["image_size"], 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    K7.launch = record
    try:
        with torch.inference_mode():
            apply(params, x.to(dtype))
    finally:
        K7.launch = launch
    torch.cuda.synchronize()
    return ops


def epilogue_rows() -> dict:
    """K7's row: for each of :data:`EPILOGUE_MODELS`, the recorded
    epilogues of one forward, each K7 launch against the plain version bit
    for bit (one launch a call), then the whole set's device time
    (``time_graph``: the batch sets' operands exceed the L2, so each is
    read from device memory; b1's 14 MB replays from the L2), its bound
    (each y and residual read once, y written once, at 3.35 TB/s), the
    plain version's and the library's time over the same set.  Returns the flagship's numbers as the
    kernel table's (ms, plain_ms, bound_ms, library_ms, events), with
    every model's row under ``rows``."""
    from fastdepth_tpu_torch.engine.benchmark import bound_us, time_graph, time_pipelined
    from fastdepth_tpu_torch.ops.cuda import epilogue as K7

    def library(y, b, residual, act):
        y.add_(b.reshape(1, -1, 1, 1))
        if residual is not None:
            y = y + residual
        return {K7.NONE: lambda v: v, K7.RELU: torch.relu,
                K7.RELU6: lambda v: torch.clamp(v, 0, 6)}[act](y)

    rows = []
    for name, batch, dtype in EPILOGUE_MODELS:
        ops = _recorded_epilogues(name, batch, dtype)
        with torch.inference_mode():
            for y, b, r, a in ops:
                want = K7.conv_epilogue_reference(y, b, r, a)
                (before,) = _counts("K7")
                got = K7.conv_epilogue(y.clone(), b, r, a)
                if _counts("K7") != (before + 1,) or not torch.equal(got, want):
                    fail(f"K7 {name} b{batch} {dtype}: the epilogue of y{tuple(y.shape)} "
                         f"(residual {r is not None}, act {a}) is not its plain version bit "
                         f"for bit (max|diff| {float((got.float() - want.float()).abs().max())})")
            del got, want
            nbytes = sum(y.element_size() * (y.numel() * (3 if r is not None else 2) + b.numel())
                         for y, b, r, _ in ops)

            def over_set(fn):
                def run():
                    for op in ops:
                        fn(*op)
                return run

            row = {"model": name, "batch": batch, "dtype": str(dtype), "epilogues": len(ops),
                   "residuals": sum(r is not None for _, _, r, _ in ops),
                   "elements": sum(y.numel() for y, *_ in ops), "bytes": nbytes,
                   "bound_ms": bound_us(nbytes)[0] / 1e3,
                   "ms": time_graph(over_set(K7.launch), [()], calls=3) * 1e3,
                   "plain_ms": time_graph(over_set(K7.conv_epilogue_reference), [()],
                                          calls=3) * 1e3,
                   "library_ms": time_graph(over_set(library), [()], calls=3) * 1e3,
                   "events_ms": time_pipelined(over_set(K7.launch), calls=3)["mean_s"]
                   * 1e3,
                   "plain_events_ms": time_pipelined(over_set(K7.conv_epilogue_reference),
                                                     calls=3)["mean_s"] * 1e3}
        row["bound_pct"] = 100 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"K7 {'bf16' if dtype == torch.bfloat16 else 'f32'} b{batch} {name}: "
              f"{row['epilogues']} epilogues ({row['residuals']} with a residual, "
              f"{row['elements'] / batch:,.0f} elements a frame), each bit for bit its "
              f"plain version; device {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"(bytes; {row['bound_pct']:.1f}% of it), plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms (add_ + residual + act); events "
              f"{row['events_ms']:.4f} ms, plain {row['plain_events_ms']:.4f} ms")
        del ops
        torch.cuda.empty_cache()
    first = rows[0]
    return {"max_abs_err": 0.0, "bound_by": "bytes", "rows": rows,
            "replaces": "none: XLA fused the bias and activation into each TPU conv",
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "events_ms",
                                     "plain_events_ms")}}


# the benchmark cells' metric sums, (images, H = W, where): the first is
# the kernel table's
METRIC_SHAPES = [(128, 224, "the flagship's and UpProj's b128"), (64, 518, "DA-V2's b64"),
                 (1, 224, "metrics.evaluate's one pair, deploy's check")]


def _metric_maps(n: int, hw: int, seed: int, holes: bool = True):
    """Seeded (prediction, target) (n, hw, hw, 1) f32 on the card, in
    metres; with ``holes`` zeros in both (20% and 30%), negative
    predictions, and from n = 3 on an image whose target is all zero and
    one with no valid pixel; without, as the benchmark's cells draw them
    (0.5-10 m, every pixel valid)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(lo, span):
        return torch.rand((n, hw, hw, 1), generator=g, device="cuda") * span + lo

    if not holes:
        return draw(0.5, 9.5), draw(0.5, 9.5)
    out, tgt = draw(0.2, 7.8), draw(0.5, 8.5)
    out[draw(0.0, 1.0) < 0.2] = 0.0
    out[draw(0.0, 1.0) < 0.05] *= -1.0
    tgt[draw(0.0, 1.0) < 0.3] = 0.0
    if n >= 3:
        tgt[1] = 0.0
        out[2] = 0.0
        tgt[2] = 0.0
    return out, tgt


def metric_sums_rows() -> dict:
    """K8's row: at each of :data:`METRIC_SHAPES`, K8 against its plain
    version on :func:`_metric_maps` with holes: the counts and delta sums
    equal, the float sums within 1e-5 relative (NaN and inf where the
    plain version's are), two launches the same bits, one launch a call;
    then on maps drawn as the cells draw them its device time
    (``time_graph`` over copies that together exceed the L2), its bound
    (8 bytes a pixel read, 40 an image written, at 3.35 TB/s), the plain
    version's time (ATen, op by op) and both event times, and its device
    time on the maps with holes.  Returns the first shape's numbers as
    the kernel table's, every shape's under ``rows``, and the largest
    absolute and relative gaps from the plain version's finite sums over
    all shapes, as measured here (the counts and delta sums are equal)."""
    from fastdepth_tpu_torch import metrics as M
    from fastdepth_tpu_torch.engine.benchmark import (bound_us, cold_copies, time_graph,
                                                      time_pipelined)
    from fastdepth_tpu_torch.ops.cuda import metric_sums as K8

    exact = [M.SUM_FIELDS.index(f) for f in ("delta1", "delta2", "delta3")] + [K8.FIELDS - 1]
    floats = [i for i in range(K8.FIELDS) if i not in exact]
    rows = []
    for n, hw, where in METRIC_SHAPES:
        nbytes = 8 * n * hw * hw + 4 * K8.FIELDS * n
        copies = cold_copies(nbytes)
        out, tgt = _metric_maps(n, hw, 0)
        (before,) = _counts("K8")
        got, again = M.metric_sums(out, tgt), M.metric_sums(out, tgt)
        plain = M.metric_sums_reference(out, tgt)
        torch.cuda.synchronize()
        g, p = got[floats].double(), plain[floats].double()
        finite = torch.isfinite(p)
        gap = (g - p).abs()[finite]
        rel = float((gap / p.abs()[finite].clamp_min(1e-30)).max())
        abs_err = float(gap.max())
        if (_counts("K8") != (before + 2,)
                or not torch.equal(got.view(torch.int32), again.view(torch.int32))
                or not torch.equal(got[exact], plain[exact]) or not rel <= 1e-5
                or not torch.equal(torch.isfinite(g), finite)
                or not torch.equal(g[~finite].nan_to_num(), p[~finite].nan_to_num())):
            fail(f"K8 b{n} {hw}x{hw}: not its plain version (launches "
                 f"{_counts('K8')[0] - before}, same bits twice "
                 f"{torch.equal(got.view(torch.int32), again.view(torch.int32))}, counts and "
                 f"deltas equal {torch.equal(got[exact], plain[exact])}, float sums' largest "
                 f"relative gap {rel:.3e})")
        holes_ms = time_graph(M.metric_sums,
                              [_metric_maps(n, hw, seed) for seed in range(copies)]) * 1e3
        torch.cuda.empty_cache()
        sets = [_metric_maps(n, hw, seed, holes=False) for seed in range(copies)]
        out, tgt = sets[0]
        with torch.inference_mode():
            row = {"images": n, "H": hw, "W": hw, "where": where, "chunks":
                   K8.chunks(out, tgt), "bytes": nbytes, "max_abs_err": abs_err,
                   "max_rel_err": rel, "holes_ms": holes_ms,
                   "bound_ms": bound_us(nbytes)[0] / 1e3,
                   "ms": time_graph(M.metric_sums, sets) * 1e3,
                   "plain_ms": time_graph(M.metric_sums_reference, sets, calls=len(sets)) * 1e3,
                   "events_ms": time_pipelined(M.metric_sums, (out, tgt))["mean_s"] * 1e3,
                   "plain_events_ms": time_pipelined(M.metric_sums_reference,
                                                     (out, tgt))["mean_s"] * 1e3}
        row["bound_pct"] = 100 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"K8 b{n} {hw}x{hw} ({where}): {row['chunks']} chunks an image, counts and "
              f"deltas equal to the plain version's, float sums within {abs_err:.3e} "
              f"({rel:.3e} relative) of it, the same bits twice; device {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"(bytes; {row['bound_pct']:.1f}% of it), plain {row['plain_ms']:.4f} ms; "
              f"events {row['events_ms']:.4f} ms, plain {row['plain_events_ms']:.4f} ms; with "
              f"holes {holes_ms:.4f} ms")
        del sets, out, tgt, got, again, plain
        torch.cuda.empty_cache()
    first = rows[0]
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows), "bound_by": "bytes",
            "rows": rows, "library_ms": None,
            "replaces": "none: XLA fused the metric ops on the TPU",
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "events_ms",
                                     "plain_events_ms")}}


class _Frames:
    """A loader over host batches already in memory: (rgb, depth, count)."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = range(sum(b[2] for b in batches))

    def __iter__(self):
        return iter(self.batches)


def _frames(pipe, seed: int, n_batches: int = E2E_BATCHES):
    """``n_batches`` batches of seeded raw 480x640 uint8 RGB + f32 depth
    frames (the NYU h5 item format), put through the shared val pipeline
    (resize/crop to 224x224) and /255, as NYUDataset's host path does."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_batches):
        rgb = rng.randint(0, 256, (BATCH, 480, 640, 3), dtype=np.uint8)
        depth = rng.uniform(0.5, 10.0, (BATCH, 480, 640)).astype(np.float32)
        batches.append((pipe.apply_batch(rgb).astype(np.float32) / 255.0,
                        pipe.apply_batch(depth)[..., None], BATCH))
    return batches


def load_weights():
    """(model, params on the CPU) of the committed trained weights."""
    from fastdepth_tpu_torch import build, load_checkpoint, params_from_jax

    tree, cfg, _ = load_checkpoint(WEIGHTS)
    model = build(cfg)
    return model, model.load(params_from_jax(tree))


def _counts(*labels):
    """The launches so far of the kernels ``labels`` ("K1" ... "K8"),
    as ``ops/cuda/kernel.COUNTER`` counts them."""
    from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER

    return tuple(COUNTER[k] for k in labels)


def _reset(*labels):
    from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER

    for k in labels:
        COUNTER[k] = 0


def _check_k7(label: str, k7: int, forwards: int, per_forward: int = EPILOGUES_PER_FORWARD):
    """Fail unless K7 launched ``per_forward`` times a forward: a routed
    conv lost or run twice shows here."""
    if k7 != per_forward * forwards:
        fail(f"{label}: K7 launched {k7} times over {forwards} forwards, want {per_forward} a "
             "forward (one a folded conv)")


def e2e_phase(model, params) -> dict:
    from fastdepth_tpu_torch import OUTPUT_SIZE, RAW_SIZE, Evaluator, ValPipeline, validate

    loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                             seed=0))
    rgb0, depth0, _ = loader.batches[0]
    forwards = E2E_BATCHES + 1  # validate() warms up on the first batch
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ev = Evaluator(model, params, batch_size=BATCH, dtype=dtype, impl="auto",
                       device="cuda")
        _reset("K1", "K4", "K7", "K8")
        avg = validate(loader, ev, print_freq=0, make_images=False,
                       log=lambda s: print(s.strip().replace("\n", " ")))
        torch.cuda.synchronize()
        k1, k4, k7, k8 = _counts("K1", "K4", "K7", "K8")
        if (k1, k4, k8) != (STAGES_PER_FORWARD * forwards, forwards, forwards):
            fail(f"{name}: K1 launched {k1}, K4 {k4} and K8 {k8} times over {forwards} "
                 f"steps, want {STAGES_PER_FORWARD}, 1 and 1 per step")
        _check_k7(name, k7, forwards)
        print(f"eval {name}: K1 {k1}, K4 {k4}, K7 {k7}, K8 {k8} launches over {forwards} "
              "steps")
        x, d = ev.put(rgb0), ev.put(depth0)
        pred, _ = ev(x, d)
        torch.cuda.synchronize()
        if tuple(pred.shape) != (BATCH, *OUTPUT_SIZE, 1) or not torch.isfinite(pred).all():
            fail(f"{name}: predictions of shape {tuple(pred.shape)}, finite: "
                 f"{bool(torch.isfinite(pred).all())}")
        fps = BATCH / _median_ms(ev, (x, d)) * 1e3
        if name == "f32":
            _check_evaluator_uint8(ev)
        row = {k: getattr(avg, k) for k in ("rmse", "mae", "delta1", "absrel", "lg10")}
        out[name] = {"launches": k1, "k4_launches": k4, "k7_launches": k7, "k8_launches": k8,
                     "forwards": forwards,
                     "metrics": row,
                     "validate_fps": 1.0 / avg.gpu_time, "step_fps": fps}
        if name == "f32":
            # the fused forward against the port's straight plain-PyTorch
            # forward, same weights and frames, TF32 off: 1e-3 absolute
            # covers summation order over 28 conv layers
            plain = Evaluator(model, params, batch_size=BATCH, impl="xla", device="cuda")
            want, _ = plain(x, d)
            err = float((pred - want).abs().max())
            print(f"e2e f32: fused vs straight forward max|diff| {err:.3e} (bound 1e-3)")
            if not err <= 1e-3:
                fail(f"fused forward disagrees with the straight forward: {err}")
            out[name]["max_abs_err_vs_straight"] = err
            out[name]["straight_step_fps"] = BATCH / _median_ms(plain, (x, d)) * 1e3
        print(f"e2e {name}: {json.dumps(out[name])}")
    return out


def _check_evaluator_uint8(ev) -> None:
    """The Evaluator's uint8 path (``--device-normalize``) hands its forward
    the host path's f32 frames (numpy's /255) bit for bit on all 256
    values, on the card: its forward is swapped for one that records its
    input."""
    seen = []

    def record(params, x):
        seen.append(x.cpu())
        return torch.zeros((*x.shape[:3], 1), device=x.device)

    raw = np.stack([np.arange(256, dtype=np.uint8).reshape(16, 16)] * 3, axis=-1)[None]
    forward, ev._apply = ev._apply, record
    try:
        ev(ev.put(raw), ev.put(np.ones((1, 16, 16, 1), np.float32)))
    finally:
        ev._apply = forward
    want = raw.astype(np.float32) / np.float32(255)
    off = int((seen[0].numpy() != want).sum())
    scalar = (torch.from_numpy(raw).cuda().float() / 255.0).cpu().numpy()
    scalar_err = float(np.abs(scalar - want).max())
    print(f"e2e: Evaluator's uint8 path on the card vs the host path's /255: {off} of 768 "
          f"values differ (bound 0); a division by the Python number 255.0 on the card: "
          f"{int((scalar != want).sum())} differ, max|diff| {scalar_err:.3e}")
    if off:
        fail(f"the Evaluator's uint8 normalisation differs from the host path on {off} values")


def forwards_phase(model, params) -> dict:
    """apply_fastdepth_fused_v2 / _v3 at batch 8 on the trained weights:
    5 launches of K2 or K3 and 1 of K4 per forward; f32 within 1e-3 of the
    straight forward (TF32 off), bf16 finite.  Also times each forward
    (and the K1 and straight ones) per call, CUDA events."""
    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.models import fused as F

    cfg = model.config
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(BATCH, *OUTPUT_HW, 3).astype(np.float32)).cuda()
    runs = 3
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p, _ = _prepare(model, params, batch_size=BATCH, dtype=dtype, fold_bn=True,
                        impl="xla", device="cuda")
        xd = x.to(dtype)
        forwards = {
            "v2": (lambda: F.apply_fastdepth_fused_v2(p, xd, cfg), "K2"),
            "v3": (lambda: F.apply_fastdepth_fused_v3(p, xd, cfg), "K3"),
            "fused": (lambda: F.apply_fastdepth_fused(p, xd, cfg), "K1"),
            "straight": (lambda: model.apply(p, xd), None),
        }
        with torch.inference_mode():
            want = model.apply(p, xd).float()
            row = {}
            for fwd, (fn, stage) in forwards.items():
                if stage is not None and fwd != "fused":
                    _reset(stage, "K4", "K7")
                    for _ in range(runs):
                        got = fn().float()
                    torch.cuda.synchronize()
                    *launches, k7 = _counts(stage, "K4", "K7")
                    _check_k7(f"{fwd} {name}", k7, runs)
                    if launches != [STAGES_PER_FORWARD * runs, runs]:
                        fail(f"{fwd} {name}: launches {launches} over {runs} forwards, want "
                             f"{STAGES_PER_FORWARD} of the stage kernel and 1 of K4 each")
                    if tuple(got.shape) != (BATCH, *OUTPUT_HW, 1) or not torch.isfinite(got).all():
                        fail(f"{fwd} {name}: output of shape {tuple(got.shape)}, finite: "
                             f"{bool(torch.isfinite(got).all())}")
                    err = float((got - want).abs().max())
                    print(f"{fwd} {name}: vs straight forward max|diff| {err:.3e}"
                          + (" (bound 1e-3)" if dtype == torch.float32 else ""))
                    if dtype == torch.float32 and not err <= 1e-3:
                        fail(f"{fwd} forward disagrees with the straight forward: {err}")
                    row[fwd] = {"launches": launches[0], "k4_launches": launches[1],
                                "k7_launches": k7, "forwards": runs,
                                "max_abs_err_vs_straight": err}
                row.setdefault(fwd, {})["forward_ms"] = _median_ms(lambda: fn(), ())
        print(f"forwards {name} b{BATCH}: {json.dumps(row)}")
        out[name] = row
    return out


def deploy_phase(model, params) -> dict:
    """cli.deploy.main on a seeded 224x224 rgb npy with the trained
    weights, f32 and --bf16, with randomized-input timing.  Every call of
    the forward launches K1 five times, K4 once and K7 27 times: the
    compile's three runs (warm-up, side-stream warm-up, capture) through
    their wrappers, every later call, each a replay of the graph, in
    ``engine.aot.GRAPH_REPLAYS``; the f32 prediction is held against the
    straight forward (1e-3)."""
    from fastdepth_tpu_torch.cli import deploy
    from fastdepth_tpu_torch.engine import aot
    from fastdepth_tpu_torch.engine.aot import compile_forward

    rgb = np.random.RandomState(3).rand(*OUTPUT_HW, 3).astype(np.float32)
    # compile_forward's warm run, the saved prediction, then warmup + run
    # twice (fixed and randomized input)
    calls = 2 + 2 * (DEPLOY_WARMUP + DEPLOY_RUN)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_fp = os.path.join(tmp, "rgb.npy")
        np.save(in_fp, rgb)
        for name, extra in (("f32", []), ("bf16", ["--bf16"])):
            out_fp = os.path.join(tmp, f"pred_{name}.npy")
            _reset("K1", "K4", "K7")
            aot.GRAPH_REPLAYS = 0
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                deploy.main(["--model", WEIGHTS, "--input-fp", in_fp, "--output-fp", out_fp,
                             "--warmup", str(DEPLOY_WARMUP), "--run", str(DEPLOY_RUN),
                             "--randomized-input-timing", "--device", "cuda"] + extra)
            torch.cuda.synchronize()
            for line in log.getvalue().splitlines():
                print(f"deploy {name}: {line}")
            k1, k4, k7 = _counts("K1", "K4", "K7")
            replays = aot.GRAPH_REPLAYS
            # a replay runs K7 without its Python: the eager runs count
            _check_k7(f"deploy {name}", k7, calls + CAPTURE_RUNS - replays)
            if replays != calls - 1 or (k1 + STAGES_PER_FORWARD * replays, k4 + replays) != (
                    STAGES_PER_FORWARD * (calls + CAPTURE_RUNS), calls + CAPTURE_RUNS):
                fail(f"deploy {name}: K1 launched {k1} and K4 {k4} times and the graph "
                     f"replayed {replays} times over {calls} calls, want {STAGES_PER_FORWARD} "
                     f"and 1 per call and per capture run, every call after the compile a "
                     f"replay")
            pred = np.load(out_fp)
            if pred.shape != (1, 1, *OUTPUT_HW) or not np.isfinite(pred).all():
                fail(f"deploy {name}: saved prediction of shape {pred.shape}, finite: "
                     f"{bool(np.isfinite(pred).all())}")
            timed = re.search(r"\[timed\] mean=([\d.]+) ms  median=([\d.]+) ms", log.getvalue())
            rand = re.search(r"\[randomized\] mean=([\d.]+) ms  median=([\d.]+) ms",
                             log.getvalue())
            out[name] = {"launches": k1, "k4_launches": k4, "k7_launches": k7,
                         "replays": replays, "calls": calls,
                         "timed_median_ms": float(timed.group(2)),
                         "randomized_median_ms": float(rand.group(2))}
            if name == "f32":
                fn, p = compile_forward(model, params, batch_size=1, image_size=OUTPUT_HW,
                                        impl="xla", device="cuda")
                want = fn(p, torch.from_numpy(rgb[None]).cuda()).permute(0, 3, 1, 2)
                err = float(np.abs(pred - want.cpu().numpy()).max())
                print(f"deploy f32: saved prediction vs straight forward max|diff| {err:.3e} "
                      "(bound 1e-3)")
                if not err <= 1e-3:
                    fail(f"deploy prediction disagrees with the straight forward: {err}")
                out[name]["max_abs_err_vs_straight"] = err
                out["fresh_f32"] = fresh_deploy_f32(in_fp, os.path.join(tmp, "pred_fresh.npy"),
                                                    want.cpu().numpy())
            print(f"deploy {name}: {json.dumps(out[name])}")
    return out


FRESH_DEPLOY_CALLS = 2 + 2 + 5  # compile_forward's warm run, the saved prediction, 2 + 5


def fresh_deploy_f32(in_fp: str, out_fp: str, want: np.ndarray, extra=(),
                     per_call=(STAGES_PER_FORWARD, 1, EPILOGUES_PER_FORWARD),
                     label: str = "deploy f32") -> dict:
    """cli.deploy.main in f32 (``extra`` flags on top) in a fresh process,
    whose TF32 flags start at PyTorch's defaults (cuDNN's on): the CLI
    must turn both off, its saved prediction must agree with ``want``,
    the straight forward with TF32 off, within 1e-3, and K1, K4 and K7
    must have launched ``per_call`` times a call of the forward and a
    capture run, a replay of the graph counting as a call."""
    argv = ["--model", WEIGHTS, "--input-fp", in_fp, "--output-fp", out_fp, "--warmup", "2",
            "--run", "5", "--device", "cuda", *extra]
    code = ("import json, torch\n"
            "def flags():\n"
            "    return [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]\n"
            "before = flags()\n"
            "from fastdepth_tpu_torch.cli import deploy\n"
            "from fastdepth_tpu_torch.engine import aot\n"
            "from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER\n"
            f"deploy.main({argv!r})\n"
            "print('TF32 ' + json.dumps({'before': before, 'after': flags(),\n"
            "                            'launches': [COUNTER[k] for k in ('K1', 'K4', 'K7')],\n"
            "                            'replays': aot.GRAPH_REPLAYS}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        fail(f"{label} in a fresh process exited {r.returncode}: {r.stderr[-2000:]}")
    flags = json.loads(r.stdout.rsplit("TF32 ", 1)[1])
    pred = np.load(out_fp)
    err = float(np.abs(pred - want).max())
    launches, replays = flags["launches"], flags["replays"]
    print(f"{label}, fresh process: TF32 flags (cudnn, matmul) {flags['before']} before, "
          f"{flags['after']} after; K1 {launches[0]}, K4 {launches[1]}, K7 {launches[2]} "
          "launches and "
          f"{replays} graph replays over {FRESH_DEPLOY_CALLS} calls; saved prediction vs "
          f"straight forward max|diff| {err:.3e} (bound 1e-3)")
    if flags["after"] != [False, False]:
        fail(f"{label} left TF32 on: {flags['after']}")
    if not err <= 1e-3:
        fail(f"fresh-process {label} disagrees with the straight forward: {err}")
    runs = FRESH_DEPLOY_CALLS + CAPTURE_RUNS
    if replays != FRESH_DEPLOY_CALLS - 1 or [n + k * replays for n, k in zip(
            launches, per_call)] != [k * runs for k in per_call]:
        fail(f"{label}: K1 {launches[0]}, K4 {launches[1]} and K7 {launches[2]} launches and "
             f"{replays} graph replays over {FRESH_DEPLOY_CALLS} calls, want {per_call[0]}, "
             f"{per_call[1]} and {per_call[2]} a call and a capture run, every call after the "
             "compile a replay")
    return {"tf32_before": flags["before"], "tf32_after": flags["after"],
            "max_abs_err_vs_straight": err, "launches": launches[0],
            "k4_launches": launches[1], "k7_launches": launches[2], "replays": replays,
            "calls": FRESH_DEPLOY_CALLS}


def _serve_one(srv, tmp: str, name: str, inputs, lone_inputs,
               per_forward=(STAGES_PER_FORWARD, 1, EPILOGUES_PER_FORWARD)):
    """Drive one server through its unix socket: a warm-up request, then
    (K1's, K4's and K7's counts set to 0 just before, read just after)
    the stream of ``inputs`` at depth SERVE_DEPTH and SERVE_LONE lone
    requests, then SERVE_TIMED more streams that are only timed.  K1, K4
    and K7 must have launched ``per_forward`` times a forward over the
    counted run (the flagship's 5, 1 and 27; ResNet-50-UpProj's 0, 0 and
    70).  Returns (stream answers, lone answers, row)."""
    import threading

    from fastdepth_tpu_torch.engine.server import request, request_stream, serve_unix_socket

    sock = os.path.join(tmp, f"{name}.sock")
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=serve_unix_socket, args=(srv, sock),
                         kwargs={"ready": ready, "stop": stop, "log": lambda *a: None},
                         daemon=True)
    t.start()
    try:
        if not ready.wait(30):
            fail(f"serve {name}: the socket never came up")
        request(sock, lone_inputs[0])  # warm-up: the first forward's set-up
        before = srv.stats()
        _reset("K1", "K4", "K7")
        t0 = time.perf_counter()
        answers = list(request_stream(sock, inputs, depth=SERVE_DEPTH))
        stream_s = [time.perf_counter() - t0]
        lone, lone_ms = [], []
        for x in lone_inputs:
            t0 = time.perf_counter()
            lone.append(request(sock, x))
            lone_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        k1, k4, k7 = _counts("K1", "K4", "K7")
        after = srv.stats()
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            n = sum(1 for _ in request_stream(sock, inputs, depth=SERVE_DEPTH))
            stream_s.append(time.perf_counter() - t0)
            if n != len(inputs):
                fail(f"serve {name}: a timed stream answered {n} of {len(inputs)} frames")
        stats = srv.stats()  # latency and occupancy over the wire's requests
        inproc_ms = []
        for x in lone_inputs:
            t0 = time.perf_counter()
            srv.submit(x).result(timeout=60)
            inproc_ms.append((time.perf_counter() - t0) * 1e3)
        # the same frames submitted in process at once: the server
        # without the wire
        t0 = time.perf_counter()
        for fut in [srv.submit(x) for x in inputs]:
            fut.result(timeout=60)
        burst_fps = len(inputs) / (time.perf_counter() - t0)
    finally:
        stop.set()
        t.join(30)
        srv.close()
    if t.is_alive():
        fail(f"serve {name}: the accept loop did not stop")
    if len(answers) != len(inputs):
        fail(f"serve {name}: the stream answered {len(answers)} of {len(inputs)} frames")
    batches = after["batches"] - before["batches"]
    frames = after["frames"] - before["frames"]
    # a batch launches K1 once a level and K4 once; chain runs a batch-1
    # forward a frame (the padded tail of a window is never run)
    forwards = frames if srv.chain else batches
    if not ((k1, k4, k7) == tuple(k * forwards for k in per_forward) and forwards > 0):
        fail(f"serve {name}: K1 launched {k1}, K4 {k4} and K7 {k7} times over {forwards} "
             f"forwards ({batches} batches, {frames} frames), want {per_forward[0]}, "
             f"{per_forward[1]} and {per_forward[2]} a forward")
    fps = [len(inputs) / s for s in stream_s]
    row = {"launches": k1, "k4_launches": k4, "k7_launches": k7, "batches": batches,
           "frames": frames,
           "stream_fps": fps, "stream_fps_median": float(np.median(fps)),
           "lone_round_trip_ms": lone_ms, "lone_round_trip_ms_median": float(np.median(lone_ms)),
           "lone_in_process_ms_median": float(np.median(inproc_ms)),
           "in_process_burst_fps": burst_fps,
           "latency_ms": stats["latency_ms"], "mean_occupancy": stats["mean_occupancy"]}
    return answers, lone, row


def _print_serve(label: str, row: dict, card: dict) -> None:
    lat = row["latency_ms"]
    print(f"{label} on {card['nvidia_smi']}: {SERVE_FRAMES} frames streamed at depth "
          f"{SERVE_DEPTH}: " + ", ".join(f"{f:.1f}" for f in row["stream_fps"])
          + f" frames/s (in process, no wire: {row['in_process_burst_fps']:.1f}); stats p50 "
          f"{lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms over {lat['count']} requests, mean "
          f"occupancy {row['mean_occupancy']:.3f}; lone frame round trip median "
          f"{row['lone_round_trip_ms_median']:.3f} ms (in process "
          f"{row['lone_in_process_ms_median']:.3f} ms); K1 {row['launches']}, K4 "
          f"{row['k4_launches']}, K7 {row['k7_launches']} launches over {row['batches']} "
          f"batches / {row['frames']} "
          f"frames; max|diff| {row['max_abs_err']:.3e} (bound {row['bound']:.3e})")


def serve_phase(model, params, card: dict) -> dict:
    """The serving daemon on the committed weights at 224x224 (see
    :func:`_serve_one` for what each server is driven through): f32 at
    batch 8 and chain (window SERVE_CHAIN) within 1e-3 of the straight
    forward (TF32 off) of the same frames; uint8 in / f16 out within 1e-3
    + 2^-10 max|ref| of the straight forward of raw/255; bf16 at batch 8
    within 2^-7 max|ref| of the port's bf16 fused forward called directly
    on the same frames.  First, engine.server.normalize on the card bit
    for bit against numpy's division on all 256 uint8 values (and how
    many of them a division by a Python number, a multiply by the
    reciprocal on CUDA, gets wrong)."""
    from fastdepth_tpu_torch.engine.aot import _prepare, compile_forward
    from fastdepth_tpu_torch.engine.server import InferenceServer, normalize

    values = np.arange(256, dtype=np.uint8)
    want_u8 = values.astype(np.float32) / np.float32(255)
    on_card = torch.from_numpy(values).cuda()
    got_u8 = normalize(on_card, torch.float32).cpu().numpy()
    if not np.array_equal(got_u8, want_u8):
        fail(f"serve: normalize differs from numpy's /255 on "
             f"{int((got_u8 != want_u8).sum())} of 256 values")
    scalar_off = int(((on_card.float() / 255.0).cpu().numpy() != want_u8).sum())
    print(f"serve: normalize bit for bit with numpy's /255 on 256 of 256 values; a division "
          f"by the Python number 255.0 on the card differs on {scalar_off}")

    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, (SERVE_FRAMES, *OUTPUT_HW, 3), dtype=np.uint8)
    frames = raw.astype(np.float32) / np.float32(255)  # == normalize, checked above
    fn, p = compile_forward(model, params, batch_size=BATCH, image_size=OUTPUT_HW,
                            impl="xla", device="cuda")
    want = np.concatenate([fn(p, torch.from_numpy(frames[i:i + BATCH]).cuda()).cpu().numpy()
                           for i in range(0, SERVE_FRAMES, BATCH)])
    pb, apply_bf16 = _prepare(model, params, batch_size=BATCH, dtype=torch.bfloat16,
                              fold_bn=True, impl="fused", device="cuda")
    with torch.inference_mode():
        want_bf16 = np.concatenate([
            apply_bf16(pb, torch.from_numpy(frames[i:i + BATCH]).cuda().to(torch.bfloat16))
            .float().cpu().numpy() for i in range(0, SERVE_FRAMES, BATCH)])
    scale = float(np.abs(want).max())
    servers = [  # name, server kwargs, inputs, reference, bound
        ("f32", {"batch_size": BATCH}, frames, want, 1e-3),
        ("uint8_f16", {"batch_size": BATCH, "input_dtype": np.uint8,
                       "output_dtype": np.float16}, raw, want, 1e-3 + 2 ** -10 * scale),
        ("chain", {"batch_size": SERVE_CHAIN, "chain": True}, frames, want, 1e-3),
        ("bf16", {"batch_size": BATCH, "dtype": torch.bfloat16}, frames, want_bf16,
         2 ** -7 * float(np.abs(want_bf16).max())),
    ]
    out = {"normalize_scalar_division_off": scalar_off}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw, inputs, ref, bound in servers:
            srv = InferenceServer(model, params, image_size=OUTPUT_HW, device="cuda", **kw)
            answers, lone, row = _serve_one(srv, tmp, name, list(inputs),
                                            list(inputs[:SERVE_LONE]))
            got = np.stack(answers + lone).astype(np.float32)
            err = float(np.abs(got - np.concatenate([ref, ref[:SERVE_LONE]])).max())
            row["max_abs_err"], row["bound"] = err, bound
            _print_serve(f"serve {name} b{kw['batch_size']}", row, card)
            if got.shape != (SERVE_FRAMES + SERVE_LONE, *OUTPUT_HW, 1) or not err <= bound:
                fail(f"serve {name}: answers of shape {got.shape}, max|diff| {err} > {bound}")
            out[name] = row
    return out


# --- the tuned dispatch (engine/autotune, impl='mixed') ----------------------

TUNE_CALLS = 10  # cli.autotune --calls (its default is 20)
FLAGSHIP = "mobilenet-nnconv5dw-skipadd-pruned"
# the winner maps the mixed path runs on the flagship: the card's tuned
# record (filled in by tuned_phase), a hand-mixed map, all plain stages
MIXED_MAPS = {"tuned": None,
              "hand": {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "pallas"},
              "xla": {i: "xla" for i in range(1, 6)}}
MIXED_SERVE_FRAMES = 2 * BATCH
MIXED_WIDE_BATCH = 128  # the mixed maps' eval step where the device, not the host, binds


def _tune_records(tmp: str) -> dict:
    """cli.autotune on the four released models at TUNE_CALLS: each
    record printed as one JSON line; every decoder stage needs a winner
    at both dtypes, and no impl may have failed.  Returns {model: path}."""
    from fastdepth_tpu_torch.cli import autotune

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        paths = autotune.main(["--out", tmp, "--calls", str(TUNE_CALLS), "--device", "cuda"])
    out = {}
    for path in paths:
        name = os.path.basename(path).split(".", 1)[1][:-len(".json")]
        with open(path) as f:
            rec = json.load(f)
        print(f"tuned record {os.path.basename(path)}: {json.dumps(rec)}")
        errors = [r for r in rec["records"] + rec["encoder_records"]
                  if any(k.endswith("_error") for k in r)]
        if errors:
            fail(f"autotune {name}: failed impls {errors}")
        have = {(r["stage"], r["dtype"]) for r in rec["records"] if r.get("winner")}
        want = {(i, d) for i in range(1, 6) for d in ("bfloat16", "float32")}
        if have != want:
            fail(f"autotune {name}: winners for {sorted(have)}, want every stage at both dtypes")
        winners = {d: {r["stage"]: r["winner"] for r in rec["records"] if r["dtype"] == d}
                   for d in ("bfloat16", "float32")}
        print(f"tuned {name} on {rec['device']}: winners {json.dumps(winners)}")
        out[name] = path
    print(f"autotune: {len(paths)} records in {time.perf_counter() - t0:.1f} s "
          f"(--calls {TUNE_CALLS})")
    return out


def tuned_phase(model, params, card: dict) -> dict:
    """The tuned dispatch on the card: cli.autotune's records for the four
    released models (:func:`_tune_records`); then Evaluator(impl='mixed')
    on the committed trained flagship at b8 over seeded frames with three
    winner maps (the card's tuned record, a hand-mixed map, all plain
    stages): each through validate() with K1 launched once per 'pallas'
    level and K4 once a forward (f32; bf16 too for the tuned record, whose
    map is per dtype), its f32 output within 1e-3 of the fused forward,
    its metric row, and its eval step time in turns with the fused one
    (the hand-mixed and all-plain maps also at b128);
    cli.deploy --impl mixed --tuning b1 f32 in a fresh process; and an
    InferenceServer(impl='mixed', tuning=) b8 whose answers equal the
    mixed Evaluator's forward."""
    from fastdepth_tpu_torch import OUTPUT_SIZE, RAW_SIZE, Evaluator, ValPipeline, validate
    from fastdepth_tpu_torch.engine.autotune import load_tuning
    from fastdepth_tpu_torch.engine.server import InferenceServer

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        records = _tune_records(tmp)
        path = records[FLAGSHIP]
        maps = dict(MIXED_MAPS, tuned=path)
        loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                                 seed=11))
        rgb0, depth0, _ = loader.batches[0]
        forwards = E2E_BATCHES + 1  # validate() warms up on the first batch
        fused = Evaluator(model, params, batch_size=BATCH, impl="fused", device="cuda")
        x, d = fused.put(rgb0), fused.put(depth0)
        want, _ = fused(x, d)
        runs = [(name, torch.float32) for name in maps] + [("tuned", torch.bfloat16)]
        f32_evs = {}
        for name, dtype in runs:
            label = f"mixed {name} {'f32' if dtype == torch.float32 else 'bf16'}"
            winners = maps[name] if isinstance(maps[name], dict) else load_tuning(path, dtype)
            n_pallas = sum(w == "pallas" for w in winners.values())
            ev = Evaluator(model, params, batch_size=BATCH, dtype=dtype, impl="mixed",
                           tuning=maps[name], device="cuda")
            _reset("K1", "K4", "K7")
            avg = validate(loader, ev, print_freq=0, make_images=False, log=lambda *a: None)
            torch.cuda.synchronize()
            k1, k4, k7 = _counts("K1", "K4", "K7")
            if (k1, k4) != (n_pallas * forwards, forwards):
                fail(f"{label}: K1 launched {k1} and K4 {k4} times over {forwards} forwards, "
                     f"want {n_pallas} (its 'pallas' levels) and 1 per forward")
            _check_k7(label, k7, forwards)  # an 'xla' level's convs are plain ops
            row = {"winners": winners, "launches": k1, "k4_launches": k4, "k7_launches": k7,
                   "forwards": forwards,
                   "metrics": {k: getattr(avg, k) for k in ("rmse", "mae", "delta1", "absrel",
                                                           "lg10")}}
            if dtype == torch.float32:
                got, _ = ev(x, d)
                err = float((got - want).abs().max())
                if not err <= 1e-3:
                    fail(f"{label}: output vs the fused forward max|diff| {err} > 1e-3")
                # in turns: fused, mixed, mixed, fused
                t = [_median_ms(e, (x, d)) for e in (fused, ev, ev, fused)]
                row.update(max_abs_err_vs_fused=err, step_ms=[t[1], t[2]],
                           fused_step_ms=[t[0], t[3]])
                f32_evs[name] = ev
            print(f"tuned {label} b{BATCH} on {card['nvidia_smi']}: {json.dumps(row)}")
            out[label] = row

        # the b8 step is host-bound (PERF.md section 5): the plain levels'
        # share shows at b128, in turns fused, hand, xla, xla, hand, fused
        reps = MIXED_WIDE_BATCH // BATCH
        xw, dw = torch.cat([x] * reps), torch.cat([d] * reps)
        order = (fused, f32_evs["hand"], f32_evs["xla"], f32_evs["xla"], f32_evs["hand"], fused)
        t = [_median_ms(e, (xw, dw), repeats=3, calls=10) for e in order]
        out[f"step_ms_b{MIXED_WIDE_BATCH}_f32"] = wide = {
            "fused": [t[0], t[5]], "hand": [t[1], t[4]], "xla": [t[2], t[3]]}
        print(f"tuned eval step b{MIXED_WIDE_BATCH} f32 on {card['nvidia_smi']}, ms in turns "
              f"fused, hand, xla, xla, hand, fused: {json.dumps(wide)}")
        del xw, dw

        # the deploy CLI with the tuned record, b1 f32 in a fresh process
        from fastdepth_tpu_torch.engine.aot import compile_forward

        rgb = np.random.RandomState(12).rand(*OUTPUT_HW, 3).astype(np.float32)
        in_fp = os.path.join(tmp, "rgb.npy")
        np.save(in_fp, rgb)
        fn, p = compile_forward(model, params, batch_size=1, image_size=OUTPUT_HW,
                                impl="xla", device="cuda")
        straight = fn(p, torch.from_numpy(rgb[None]).cuda()).permute(0, 3, 1, 2).cpu().numpy()
        n32 = sum(w == "pallas" for w in load_tuning(path, torch.float32).values())
        out["deploy_mixed_f32"] = fresh_deploy_f32(
            in_fp, os.path.join(tmp, "pred_mixed.npy"), straight,
            extra=("--impl", "mixed", "--tuning", path), per_call=(n32, 1, EPILOGUES_PER_FORWARD),
            label="deploy --impl mixed f32")

        # the server with the tuned record against the mixed Evaluator
        frames = np.concatenate([b[0] for b in loader.batches])[:MIXED_SERVE_FRAMES]
        ev = Evaluator(model, params, batch_size=BATCH, impl="mixed", tuning=path,
                       device="cuda")
        with torch.inference_mode():
            ref = np.concatenate([ev._apply(ev.params, torch.from_numpy(frames[i:i + BATCH])
                                            .cuda()).cpu().numpy()
                                  for i in range(0, MIXED_SERVE_FRAMES, BATCH)])
        srv = InferenceServer(model, params, batch_size=BATCH, image_size=OUTPUT_HW,
                              impl="mixed", tuning=path, device="cuda")
        try:
            srv.submit(frames[0]).result(timeout=60)  # warm-up
            before = srv.stats()["batches"]
            _reset("K1", "K4", "K7")
            answers = np.stack([f.result(timeout=60) for f in [srv.submit(fr) for fr in frames]])
            torch.cuda.synchronize()
            k1, k4, k7 = _counts("K1", "K4", "K7")
            batches = srv.stats()["batches"] - before
        finally:
            srv.close()
        err = float(np.abs(answers - ref).max())
        print(f"tuned server b{BATCH} f32: {MIXED_SERVE_FRAMES} frames in {batches} batches, "
              f"K1 {k1}, K4 {k4} launches; answers vs the mixed Evaluator's forward "
              f"max|diff| {err:.3e} (bound 1e-5)")
        if (k1, k4) != (n32 * batches, batches) or not err <= 1e-5:
            fail(f"tuned server: K1 {k1}, K4 {k4} over {batches} batches (want {n32} and 1 "
                 f"a batch), max|diff| {err}")
        _check_k7("tuned server", k7, batches)
        out["serve_mixed"] = {"launches": k1, "k4_launches": k4, "k7_launches": k7,
                              "batches": batches,
                              "max_abs_err_vs_evaluator": err}
    print(f"tuned phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --- the deploy bundle (engine/aot.save_bundle / load_bundle) --------------

BUNDLE_TURNS = 3  # deploy b1 from the bundle against from the checkpoint, in turns
BUNDLE_RECORD = os.path.join(REPO, "tuning", f"h100.{FLAGSHIP}.json")
BUNDLE_LOAD_CALLS = 1 + 2 + 5  # the saved prediction, --warmup 2, --run 5


def _bundle_loads_in_a_fresh_process(runs, in_fp: str) -> dict:
    """``cli.deploy --load-bundle`` for each ``(name, prefix, out_fp)`` of
    ``runs``, one after the other in ONE fresh process, whose TF32 flags
    start at PyTorch's defaults: the first (f32) run's flags before and
    after, and K1's and K4's launches of each run counted in that
    process.  Returns {name: {...}}."""
    code = ("import json, torch\n"
            "def flags():\n"
            "    return [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]\n"
            "from fastdepth_tpu_torch.cli import deploy\n"
            "from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER\n"
            "out = {}\n"
            f"for name, prefix, out_fp in {[tuple(r) for r in runs]!r}:\n"
            "    COUNTER.clear()\n"
            "    before = flags()\n"
            "    deploy.main(['--load-bundle', prefix, '--input-fp', " + repr(in_fp) + ",\n"
            "                 '--output-fp', out_fp, '--warmup', '2', '--run', '5',\n"
            "                 '--device', 'cuda'])\n"
            "    torch.cuda.synchronize()\n"
            "    out[name] = {'tf32_before': before, 'tf32_after': flags(),\n"
            "                 'launches': [COUNTER[k] for k in ('K1', 'K4', 'K7')]}\n"
            "print('BUNDLES ' + json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        fail(f"bundle loads in a fresh process exited {r.returncode}: {r.stderr[-2000:]}")
    for line in r.stdout.splitlines():
        if not line.startswith("BUNDLES "):
            print(f"bundle fresh process: {line}")
    return json.loads(r.stdout.rsplit("BUNDLES ", 1)[1])


def _bundle_opchecks() -> dict:
    """torch.library.opcheck of both custom ops on CUDA tensors at the
    flagship's b1 shapes: K1 at level 1 (no skip), level 2 (skip) and
    level 4 as rank 1 of a space axis of 2 (a row window), K4 on the
    224^2 head.  Each case first calls the op once: its kernel must
    launch once."""
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import head as K4

    cases = {}
    for name, (h, c, cout, skip, window) in {
            "K1 level 1": (7, 512, 200, False, None), "K1 level 2 +skip": (14, 200, 256, True, None),
            "K1 level 4 window": (56, 120, 56, True, (26, 56, 56, 112))}.items():
        x, w, sk = _k1_level_operands(1, h, c, cout, skip, torch.float32, seed=14)
        if window is not None:
            r0, _, o0, o1 = window
            x = x[:, :, r0:].contiguous(memory_format=torch.channels_last)
            sk = sk[:, :, o0:o1].contiguous(memory_format=torch.channels_last)
        cases[name] = ("K1", K1.STAGE_OP.overload,
                       (x, *w, sk, None if window is None else list(window)))
    y = torch.rand(1, 16, *OUTPUT_HW, device="cuda").contiguous(memory_format=torch.channels_last)
    cases["K4 head"] = ("K4", K4.HEAD_OP.overload, (y, torch.randn(16, device="cuda"),
                                                    torch.randn(1, device="cuda")))
    out = {}
    for name, (label, op, args) in cases.items():
        (before,) = _counts(label)
        op(*args)
        torch.cuda.synchronize()
        (after,) = _counts(label)
        if after != before + 1:
            fail(f"bundle opcheck {name}: the op launched its kernel {after - before} "
                 "times, want 1")
        try:
            result = torch.library.opcheck(op, args)
        except Exception as e:  # opcheck raises OpCheckError (or the op's own error)
            fail(f"bundle opcheck {name} on CUDA tensors: {type(e).__name__}: {e}")
        out[name] = result
        print(f"bundle opcheck {name} (CUDA tensors): {json.dumps(result)}")
    return out


DISPATCH_CALLS = 200  # calls a turn when timing the custom ops' dispatch


def _dispatch_cost(deploy_ms: float, card: dict) -> dict:
    """What the custom-op dispatcher costs the host: microseconds a call
    of K1 (level 1, b1 f32) and of K4 (the 224^2 head) through its op
    against its implementation called directly (what an eager call of
    the wrapper runs), in turns op, direct, direct, op of DISPATCH_CALLS
    calls each (host clock; the card keeps up with these launches).  A
    forward makes five K1 calls and one K4 call: their extra time against
    ``deploy_ms``, the deploy b1 median."""
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import head as K4

    x, w, _ = _k1_level_operands(1, 7, 512, 200, False, torch.float32, seed=15)
    y = torch.rand(1, 16, *OUTPUT_HW, device="cuda").contiguous(memory_format=torch.channels_last)
    hw, hb = torch.randn(16, device="cuda"), torch.randn(1, device="cuda")
    cases = {"K1": (K1.STAGE_OP.overload, K1._stage_cuda, (x, *w, None, None)),
             "K4": (K4.HEAD_OP.overload, K4._head_cuda, (y, hw, hb))}
    out = {}
    for name, (op, direct, args) in cases.items():
        us = {"op": [], "direct": []}
        for label in ("op", "direct", "direct", "op"):
            fn = op if label == "op" else direct
            fn(*args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn(*args)
            us[label].append((time.perf_counter() - t) / DISPATCH_CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = us
    extra = sum(n * (float(np.mean(out[k]["op"])) - float(np.mean(out[k]["direct"])))
                for k, n in (("K1", STAGES_PER_FORWARD), ("K4", 1)))
    out["forward_extra_us"] = extra
    out["share_of_deploy_b1"] = extra / (deploy_ms * 1e3)
    print(f"bundle dispatch cost on {card['nvidia_smi']}: host us a call, op against direct "
          f"in turns: {json.dumps({k: out[k] for k in ('K1', 'K4')})}; a forward's five K1 "
          f"and one K4 calls through the ops: +{extra:.1f} us, "
          f"{100 * out['share_of_deploy_b1']:.1f}% of the deploy b1 median {deploy_ms:.4f} ms")
    return out


def bundle_phase(model, params, card: dict) -> dict:
    """The deploy bundle on the card at 224x224, b1.  The committed
    trained flagship: cli.deploy --model --save-bundle in f32, --bf16 and
    --impl mixed --tuning (the committed tuning/h100 record), then the
    three bundles through cli.deploy --load-bundle in one fresh process
    (:func:`_bundle_loads_in_a_fresh_process`): K1 launched once a K1
    level and K4 once a call, TF32 off after the f32 load, the loaded
    prediction against the saving run's (f32 and mixed within 1e-5, bf16
    within 2^-7 * max|pred|).  Through the API: the hand-mixed map's
    bundle (3 K1 a call) and resnet50-upproj at full width with random
    weights (no K1 or K4; within 1e-5 * max(1, max|pred|) of
    compile_forward); the f32 flagship's export and load seconds, its
    output against compile_forward's, and deploy b1 medians from the
    bundle and from the checkpoint in turns; the ops' dispatch cost
    (:func:`_dispatch_cost`); then opcheck of both ops on CUDA tensors
    (:func:`_bundle_opchecks`)."""
    from fastdepth_tpu_torch.cli import deploy
    from fastdepth_tpu_torch.engine.aot import compile_forward, load_bundle, save_bundle
    from fastdepth_tpu_torch.engine.autotune import load_tuning
    from fastdepth_tpu_torch.engine.benchmark import time_fn

    t_phase = time.perf_counter()
    rgb = np.random.RandomState(14).rand(*OUTPUT_HW, 3).astype(np.float32)
    n32 = sum(w == "pallas" for w in load_tuning(BUNDLE_RECORD, torch.float32).values())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_fp = os.path.join(tmp, "rgb.npy")
        np.save(in_fp, rgb)
        cli_runs = [("f32", [], STAGES_PER_FORWARD), ("bf16", ["--bf16"], STAGES_PER_FORWARD),
                    ("mixed f32", ["--impl", "mixed", "--tuning", BUNDLE_RECORD], n32)]
        saved, loads = {}, []
        for name, extra, _ in cli_runs:
            tag = name.replace(" ", "_")
            prefix = os.path.join(tmp, tag)
            saved[name] = os.path.join(tmp, f"saved_{tag}.npy")
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                deploy.main(["--model", WEIGHTS, "--input-fp", in_fp, "--output-fp",
                             saved[name], "--warmup", "0", "--run", "1", "--device", "cuda",
                             "--save-bundle", prefix] + extra)
            if f"=> saved bundle {prefix}.pt2 + .npz" not in log.getvalue():
                fail(f"bundle {name}: cli.deploy --save-bundle printed {log.getvalue()!r}")
            loads.append((name, prefix, os.path.join(tmp, f"loaded_{tag}.npy")))
        fresh = _bundle_loads_in_a_fresh_process(loads, in_fp)
        for (name, _, per_call), (_, _, loaded_fp) in zip(cli_runs, loads):
            row = fresh[name]
            want_pred, got_pred = np.load(saved[name]), np.load(loaded_fp)
            err = float(np.abs(got_pred - want_pred).max())
            bound = (2.0 ** -7 * float(np.abs(want_pred).max()) if name == "bf16" else 1e-5)
            row.update(calls=BUNDLE_LOAD_CALLS, max_abs_err_vs_checkpoint=err, bound=bound)
            print(f"bundle {name} b{DEPLOY_BATCH} {OUTPUT_HW[0]}^2 on {card['nvidia_smi']}: "
                  f"--load-bundle in a fresh process: TF32 flags {row['tf32_before']} before, "
                  f"{row['tf32_after']} after; K1 {row['launches'][0]}, K4 {row['launches'][1]}, "
                  f"K7 {row['launches'][2]} launches over {BUNDLE_LOAD_CALLS} calls; loaded "
                  "prediction vs the "
                  f"checkpoint run's max|diff| {err:.3e} (bound {bound:.3e})")
            if row["launches"][:2] != [per_call * BUNDLE_LOAD_CALLS, BUNDLE_LOAD_CALLS]:
                fail(f"bundle {name}: K1 {row['launches'][0]} and K4 {row['launches'][1]} "
                     f"launches over {BUNDLE_LOAD_CALLS} calls, want {per_call} and 1 a call")
            _check_k7(f"bundle {name}", row["launches"][2], BUNDLE_LOAD_CALLS)
            if name != "bf16" and row["tf32_after"] != [False, False]:
                fail(f"bundle {name}: the f32 load left TF32 on: {row['tf32_after']}")
            if got_pred.shape != (1, 1, *OUTPUT_HW) or not err <= bound:
                fail(f"bundle {name}: loaded prediction {got_pred.shape} max|diff| {err} "
                     f"> {bound}")
            out[name] = row

        x = torch.from_numpy(rgb[None]).cuda()

        # the hand-mixed map through the API: 3 K1 levels a call
        hand = MIXED_MAPS["hand"]
        prefix = os.path.join(tmp, "hand")
        save_bundle(prefix, model, params, impl="mixed", tuning=hand, device="cuda")
        call, lp, _, _ = load_bundle(prefix, device="cuda")
        fn, p = compile_forward(model, params, impl="mixed", tuning=hand, device="cuda")
        _reset("K1", "K4", "K7")
        got = call(lp, x)
        torch.cuda.synchronize()
        k1, k4, k7 = _counts("K1", "K4", "K7")
        _check_k7("bundle mixed hand f32", k7, 1)
        err = float((got - fn(p, x)).abs().max())
        n_hand = sum(w == "pallas" for w in hand.values())
        print(f"bundle mixed hand f32: K1 {k1}, K4 {k4} launches a call (want {n_hand} and 1); "
              f"vs compile_forward max|diff| {err:.3e} (bound 1e-5)")
        if (k1, k4) != (n_hand, 1) or not err <= 1e-5:
            fail(f"bundle mixed hand: K1 {k1}, K4 {k4}, max|diff| {err}")
        out["mixed hand f32"] = {"winners": hand, "launches": [k1, k4, k7], "max_abs_err": err}

        # resnet50-upproj at full width, random weights: the straight path
        zmodel, zparams = _zoo_model("resnet50-upproj")
        prefix = os.path.join(tmp, "resnet50")
        save_bundle(prefix, zmodel, zparams, device="cuda")
        call, lp, _, _ = load_bundle(prefix, device="cuda")
        fn, p = compile_forward(zmodel, zparams, device="cuda")
        _reset("K1", "K4", "K7")
        got = call(lp, x)
        torch.cuda.synchronize()
        k1, k4, k7 = _counts("K1", "K4", "K7")
        _check_k7("bundle resnet50-upproj f32", k7, 1, ZOO_EPILOGUES)
        want = fn(p, x)
        err = float((got - want).abs().max())
        bound = 1e-5 * max(1.0, float(want.abs().max()))
        print(f"bundle resnet50-upproj f32: K1 {k1}, K4 {k4} launches a call (want 0 and 0); "
              f"vs compile_forward max|diff| {err:.3e} (bound {bound:.3e}), max|pred| "
              f"{float(want.abs().max()):.3e}")
        if (k1, k4) != (0, 0) or not err <= bound:
            fail(f"bundle resnet50-upproj: K1 {k1}, K4 {k4}, max|diff| {err} > {bound}")
        out["resnet50-upproj f32"] = {"launches": [k1, k4, k7], "max_abs_err": err,
                                      "bound": bound}
        del zparams, lp, p, call, fn

        # the f32 flagship: export and load seconds, then b1 in turns
        prefix = os.path.join(tmp, "api_f32")
        t = time.perf_counter()
        save_bundle(prefix, model, params, device="cuda")
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        call, lp, _, _ = load_bundle(prefix, device="cuda")
        load_s = time.perf_counter() - t
        fn, p = compile_forward(model, params, device="cuda")
        err = float((call(lp, x) - fn(p, x)).abs().max())
        if not err <= 1e-5:
            fail(f"bundle f32 (API) vs compile_forward max|diff| {err} > 1e-5")
        turns = {"checkpoint": [], "bundle": []}
        for name in ["checkpoint", "bundle", "bundle", "checkpoint"] * 2:
            if len(turns[name]) < BUNDLE_TURNS:
                f, a = (fn, (p, x)) if name == "checkpoint" else (call, (lp, x))
                turns[name].append(time_fn(f, a, warmup=DEPLOY_WARMUP, repeats=DEPLOY_RUN * 2,
                                           device="cuda")["median_s"] * 1e3)
        out["times"] = {"export_s": export_s, "load_s": load_s, "max_abs_err": err,
                        "deploy_b1_median_ms": turns}
        print(f"bundle f32 b{DEPLOY_BATCH} on {card['nvidia_smi']}: export {export_s:.2f} s, "
              f"load {load_s:.2f} s; vs compile_forward max|diff| {err:.3e}; deploy b1 median "
              f"ms in turns (checkpoint, bundle, bundle, checkpoint, ...): {json.dumps(turns)}")
        out["dispatch"] = _dispatch_cost(float(np.median(turns["checkpoint"])), card)
        out["opcheck"] = _bundle_opchecks()
    print(f"bundle phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --- the model zoo (resnet50-upproj, mobilenet-nnconv5, the sweeps) -------

ZOO_SEED = 9
ZOO_CPU_ROWS = 2  # frames of a card batch held against the CPU forward
ZOO_TRAIN_STEPS = TRAIN_ITEMS // BATCH
# the tiny MobileNet encoder of the port's tests; the shuffle decoders
# divide its width by 4 five times, so they take a 1024-wide last block
ZOO_TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
ZOO_TINY_DEC = (18, 14, 10, 6, 4)
ZOO_RESNETS = ["resnet18-nnconv5-skipadd", "resnet18-nnconv5-skipconcat",
               "resnet34-nnconv5-skipadd", "resnet34-nnconv5-skipconcat",
               ("resnet50", "add"), ("resnet50", "concat"),
               "resnet101-deconv5dw", "resnet152-upconv"]
# bf16 against the card's f32 forward: relative L2 error. Each bf16
# rounding is off by up to 2^-9 (~2e-3) of its value; ResNet-50 + UpProj
# stacks 68 rounded convs (weights and activations both bf16), whose
# errors add like a random walk, sqrt(68) * 2e-3 ~ 1.6e-2, hence 2e-2; a
# wrong kernel or layout is off by O(1).  Printed beside it: the error of
# an independent bf16 forward (PyTorch's on the CPU, the same
# fold-then-cast, weights and frames) against its own f32
ZOO_BF16_REL_L2 = 2e-2


def _zoo_err(got, want, label: str) -> float:
    """max|got - want| / max(1, max|want|), the zoo's f32 measure (bound
    1e-3: the random models' outputs reach far above 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        fail(f"zoo {label}: output of shape {got.shape}, want {want.shape}")
    if not np.isfinite(got).all():
        fail(f"zoo {label}: the card's output is not finite")
    if not np.abs(want).max() >= 1e-3:
        fail(f"zoo {label}: the CPU's output peaks at {np.abs(want).max()}: it carries no "
             "signal")
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _zoo_check(label: str, got, want, bound: float = 1e-3) -> float:
    err = _zoo_err(got, want, label)
    print(f"zoo {label}: card vs CPU straight forward, max|diff| / max(1, max|cpu|) "
          f"{err:.3e} (bound {bound:g})")
    if not err <= bound:
        fail(f"zoo {label}: the card disagrees with the CPU: {err} > {bound}")
    return err


def _cpu_forward(model, params, x: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """The port's forward on the CPU: f32, the straight forward on the
    unfolded tree (the reference); bf16, the path the card's bf16 runs
    (fold in f32, cast, engine/aot._prepare), f32 out."""
    from fastdepth_tpu_torch.engine.aot import _prepare

    x = torch.from_numpy(np.ascontiguousarray(x))
    with torch.inference_mode():
        if dtype == torch.float32:
            return model.apply(params, x).numpy()
        p, apply = _prepare(model, params, batch_size=x.shape[0], dtype=dtype, fold_bn=True,
                            impl="auto", device="cpu")
        return apply(p, x.to(dtype)).float().numpy()


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _zoo_model(spec, *, tiny_decoder: str = None):
    """(model, params on the CPU): Model.init's tree, seeded, given signal
    by ``parallel/dryrun.random_bn`` (drawn BatchNorm statistics, a
    non-negative last conv)."""
    from fastdepth_tpu_torch import ModelConfig, build, from_name
    from fastdepth_tpu_torch.parallel.dryrun import random_bn

    if tiny_decoder is not None:
        enc = (ZOO_TINY_ENC[:13] + (1024,) if tiny_decoder.startswith("shuffle")
               else ZOO_TINY_ENC)
        model = build(ModelConfig(decoder=tiny_decoder, skip=None, encoder_channels=enc,
                                  decoder_channels=ZOO_TINY_DEC))
    elif isinstance(spec, tuple):
        model = build(ModelConfig(encoder=spec[0], decoder="nnconv5", skip=spec[1],
                                  bottleneck_skips=True))
    else:
        model = from_name(spec)
    return model, random_bn(model.init(torch.Generator().manual_seed(ZOO_SEED)), ZOO_SEED)


def _zoo_serve(model, params, card: dict) -> dict:
    """An InferenceServer (b8 f32) on ``model`` behind a unix socket,
    driven as the flagship's servers are (:func:`_serve_one`, K1 and K4
    launched 0 times, K7 70 a forward) on SERVE_FRAMES seeded frames: every answer within
    1e-3 * max(1, max|ref|) of the card's straight forward of the same
    frames, the first ZOO_CPU_ROWS also against the CPU's."""
    from fastdepth_tpu_torch.engine.aot import compile_forward
    from fastdepth_tpu_torch.engine.server import InferenceServer

    frames = np.random.RandomState(ZOO_SEED).rand(SERVE_FRAMES, *OUTPUT_HW, 3).astype(np.float32)
    fn, p = compile_forward(model, params, batch_size=BATCH, image_size=OUTPUT_HW, impl="xla",
                            device="cuda")
    want = np.concatenate([fn(p, torch.from_numpy(frames[i:i + BATCH]).cuda()).cpu().numpy()
                           for i in range(0, SERVE_FRAMES, BATCH)])
    del fn, p
    srv = InferenceServer(model, params, batch_size=BATCH, image_size=OUTPUT_HW, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        answers, lone, row = _serve_one(srv, tmp, "zoo", list(frames),
                                        list(frames[:SERVE_LONE]),
                                        per_forward=(0, 0, ZOO_EPILOGUES))
    got = np.stack(answers + lone)
    want = np.concatenate([want, want[:SERVE_LONE]])
    scale = max(1.0, float(np.abs(want).max()))
    row["max_abs_err"] = _zoo_err(got, want, "serve vs the card's forward") * scale
    row["bound"] = 1e-3 * scale
    _print_serve(f"zoo serve {model.config.encoder}-{model.config.decoder} b{BATCH} f32", row,
                 card)
    if not row["max_abs_err"] <= row["bound"]:
        fail(f"zoo serve: max|diff| {row['max_abs_err']} > {row['bound']}")
    row["max_rel_err_vs_cpu"] = _zoo_check(
        "resnet50-upproj serve f32", got[:ZOO_CPU_ROWS],
        _cpu_forward(model, params, frames[:ZOO_CPU_ROWS]))
    return row


def _zoo_flagship(card: dict) -> dict:
    """resnet50-upproj at full width and 224x224, random weights
    (:func:`_zoo_model`), through every entry point on the card:
    validate() b8 f32 and bf16, cli.deploy.main b1 f32, one b8 f32 train
    step against the same step on the CPU (:func:`_step_card_vs_cpu`),
    four steps of cli.train's epoch loop b8 f32, and a server
    (:func:`_zoo_serve`); each f32 output against the port's straight
    forward on the CPU, bf16 against the card's f32 (ZOO_BF16_REL_L2)."""
    from fastdepth_tpu_torch import (OUTPUT_SIZE, RAW_SIZE, BatchLoader, Evaluator,
                                     ValPipeline, params_to_jax, save_checkpoint, validate)
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint
    from fastdepth_tpu_torch.cli import deploy
    from fastdepth_tpu_torch.cli import train as train_cli
    from fastdepth_tpu_torch.config import TrainConfig

    model, params = _zoo_model("resnet50-upproj")
    out = {"params": sum(v.numel() for v in params.state_dict().values())}
    loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                             seed=ZOO_SEED))
    rgb0, depth0, _ = loader.batches[0]
    cpu0 = _cpu_forward(model, params, rgb0[:ZOO_CPU_ROWS])
    preds = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        torch.cuda.reset_peak_memory_stats()
        ev = Evaluator(model, params, batch_size=BATCH, dtype=dtype, device="cuda")
        if next(ev.params.parameters()).device.type != "cuda":
            fail("zoo: the evaluator's params are not on the card")
        _reset("K7")
        avg = validate(loader, ev, print_freq=0, make_images=False, log=lambda s: None)
        torch.cuda.synchronize()
        _check_k7(f"zoo resnet50-upproj validate {name}", *_counts("K7"),
                  len(loader.batches) + 1, ZOO_EPILOGUES)  # validate() warms up on its first batch
        x, d = ev.put(rgb0), ev.put(depth0)
        pred, _ = ev(x, d)
        preds[name] = pred.cpu().numpy()
        ms = _median_ms(ev, (x, d))
        row = {"step_fps": BATCH / ms * 1e3, "validate_fps": 1.0 / avg.gpu_time,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "rmse": avg.rmse}
        if not np.isfinite([avg.rmse, avg.mae, avg.delta1]).all():
            fail(f"zoo validate {name}: metrics not finite: {avg}")
        if name == "f32":
            row["max_rel_err_vs_cpu"] = _zoo_check("resnet50-upproj validate f32",
                                                   preds[name][:ZOO_CPU_ROWS], cpu0)
            busy_us, top = _kernel_time(lambda: ev(x, d))
            row["kernel_ms"] = None if busy_us is None else busy_us / 1e3
            row["top_kernels_ms"] = [(k, us / 1e3) for k, us in top[:8]]
        else:
            rows = slice(0, ZOO_CPU_ROWS)
            rel = _rel_l2(preds[name][rows], preds["f32"][rows])
            cpu_rel = _rel_l2(_cpu_forward(model, params, rgb0[rows], torch.bfloat16), cpu0)
            print(f"zoo resnet50-upproj validate bf16: relative L2 error to the card's f32 "
                  f"{rel:.3e} on {ZOO_CPU_ROWS} frames ({_rel_l2(preds[name], preds['f32']):.3e} "
                  f"on {BATCH}; bound {ZOO_BF16_REL_L2:g}); the CPU's bf16 to its f32 "
                  f"{cpu_rel:.3e}")
            if not rel <= ZOO_BF16_REL_L2:
                fail(f"zoo bf16 forward: relative L2 error {rel} > {ZOO_BF16_REL_L2}")
            row.update(rel_l2_vs_f32=rel, cpu_rel_l2=cpu_rel)
        print(f"zoo resnet50-upproj eval b{BATCH} {name} on {card['nvidia_smi']}: step "
              f"{row['step_fps']:.1f} frames/s (median {ms:.3f} ms), validate() "
              f"{row['validate_fps']:.1f} frames/s, peak memory {row['peak_mem_gib']:.2f} GiB"
              + ("" if name != "f32" or row["kernel_ms"] is None else
                 f"; kernel time of one step {row['kernel_ms']:.3f} ms, largest: "
                 + "; ".join(f"{k[:70]} {v:.3f}" for k, v in row["top_kernels_ms"])))
        out[f"eval_{name}"] = row
        del ev

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "resnet50_upproj.npz")
        save_checkpoint(npz, params_to_jax(params.state_dict()), model.config)
        in_fp, out_fp = os.path.join(tmp, "rgb.npy"), os.path.join(tmp, "pred.npy")
        np.save(in_fp, rgb0[0])
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            deploy.main(["--model", npz, "--input-fp", in_fp, "--output-fp", out_fp,
                         "--warmup", "5", "--run", "20", "--device", "cuda"])
        text = log.getvalue()
        timed = re.search(r"\[timed\] mean=([\d.]+) ms  median=([\d.]+) ms", text)
        gflop = re.search(r"([\d.]+) GFLOP/frame", text)
        pred = np.load(out_fp).transpose(0, 2, 3, 1)
        row = {"median_ms": float(timed.group(2)), "gflop_per_frame": float(gflop.group(1)),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "max_rel_err_vs_cpu": _zoo_check("resnet50-upproj deploy b1 f32", pred,
                                                cpu0[:1])}
        print(f"zoo resnet50-upproj deploy b1 f32 on {card['nvidia_smi']}: median "
              f"{row['median_ms']:.3f} ms, {row['gflop_per_frame']:.3f} GFLOP/frame, peak "
              f"memory {row['peak_mem_gib']:.2f} GiB")
        out["deploy_f32"] = row

        train_ds, val_ds = _seeded_datasets(os.path.join(tmp, "nyudepthv2"))
        rgb, depth, _ = next(iter(BatchLoader(train_ds, batch_size=BATCH, shuffle=True,
                                              drop_last=True, pad_last=False, num_workers=4)))
        out["train_step_card_vs_cpu"] = _step_card_vs_cpu(
            "zoo resnet50-upproj train", model, params, torch.from_numpy(rgb),
            torch.from_numpy(depth), TrainConfig(lr=TRAIN_LR, weight_decay=1e-4))
        out_dir = os.path.join(tmp, "run")
        args = train_cli.parse_args(
            ["--arch", "resnet50-upproj", "--epochs", "1", "--batch-size", str(BATCH),
             "--eval-batch-size", str(BATCH), "--workers", "4", "--print-freq", "0",
             "--output-dir", out_dir, "--lr", str(TRAIN_LR), "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            best = train_cli.train_loop(args, model, params, train_ds, val_ds,
                                        make_images=False)
        losses = [float(v) for v in re.findall(r"=> epoch \d+: train loss ([-\w.]+)",
                                               log.getvalue())]
        tree, _, _ = load_train_checkpoint(os.path.join(out_dir, "checkpoint.npz"))
        if int(np.asarray(tree["step"])) != ZOO_TRAIN_STEPS or not np.isfinite(losses).all():
            fail(f"zoo train_loop: step {np.asarray(tree['step'])}, losses {losses}")
        from fastdepth_tpu_torch import params_from_jax

        trained = model.load(params_from_jax(tree["params"]))
        ev = Evaluator(model, trained, batch_size=1, device="cuda")
        got = ev(ev.put(rgb0[:1]), ev.put(depth0[:1]))[0].cpu().numpy()
        row = {"steps": ZOO_TRAIN_STEPS, "epoch_loss": losses,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "validate_rmse": best.rmse,
               "max_rel_err_vs_cpu": _zoo_check("resnet50-upproj trained weights, card",
                                                got, _cpu_forward(model, trained, rgb0[:1]))}
        print(f"zoo resnet50-upproj train_loop b{BATCH} f32 on {card['nvidia_smi']}: "
              f"{ZOO_TRAIN_STEPS} steps, epoch loss {losses}, peak memory "
              f"{row['peak_mem_gib']:.2f} GiB")
        out["train_loop_f32"] = row
    out["train_times"] = train_times(model, params, batches=(BATCH,), card=card)

    out["serve_f32"] = _zoo_serve(model, params, card)
    return out


def _zoo_mobilenet_nnconv5(card: dict) -> dict:
    """mobilenet-nnconv5 (BASELINE config #2) at full width: validate() b8
    f32 through the head-commute forward, which _pick_apply must choose,
    with K1 and K4 launched 0 times and K7 27 a forward (its encoder)."""
    from fastdepth_tpu_torch import OUTPUT_SIZE, RAW_SIZE, Evaluator, ValPipeline, validate
    from fastdepth_tpu_torch.models import fused as F

    model, params = _zoo_model("mobilenet-nnconv5")
    loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                             seed=ZOO_SEED + 1))
    calls = []
    opt = F.apply_fastdepth_opt
    F.apply_fastdepth_opt = lambda *a: calls.append(1) or opt(*a)
    try:
        ev = Evaluator(model, params, batch_size=BATCH, device="cuda")
        _reset("K1", "K4", "K7")
        avg = validate(loader, ev, print_freq=0, make_images=False, log=lambda s: None)
        torch.cuda.synchronize()
        k1, k4, k7 = _counts("K1", "K4", "K7")
        forwards, opt_forwards = E2E_BATCHES + 1, len(calls)
        _check_k7("zoo mobilenet-nnconv5", k7, forwards)
        if (opt_forwards, k1, k4) != (forwards, 0, 0):
            fail(f"zoo mobilenet-nnconv5: {opt_forwards} opt forwards of {forwards}, K1 {k1}, "
                 f"K4 {k4} launches (want all forwards through opt, no kernel)")
        rgb0, depth0, _ = loader.batches[0]
        x, d = ev.put(rgb0), ev.put(depth0)
        pred = ev(x, d)[0].cpu().numpy()
        fps = BATCH / _median_ms(ev, (x, d)) * 1e3
    finally:
        F.apply_fastdepth_opt = opt
    err = _zoo_check("mobilenet-nnconv5 validate f32 (opt)", pred[:ZOO_CPU_ROWS],
                     _cpu_forward(model, params, rgb0[:ZOO_CPU_ROWS]))
    print(f"zoo mobilenet-nnconv5 eval b{BATCH} f32 (opt) on {card['nvidia_smi']}: step "
          f"{fps:.1f} frames/s, validate() {1.0 / avg.gpu_time:.1f} frames/s; opt forwards "
          f"{opt_forwards} of {forwards}, K1 {k1}, K4 {k4}")
    return {"opt_forwards": opt_forwards, "k1_launches": k1, "k4_launches": k4,
            "k7_launches": k7, "step_fps": fps,
            "max_rel_err_vs_cpu": err}


def _zoo_sweep() -> dict:
    """Every registry decoder on the tiny MobileNet encoder, then the
    ResNets at full width: one b2 f32 forward at 224x224 each, through
    compile_forward (fold, then _pick_apply's choice) on the card, against
    the straight forward on the CPU."""
    from fastdepth_tpu_torch.config import DECODER_NAMES
    from fastdepth_tpu_torch.engine.aot import compile_forward

    x = np.random.RandomState(ZOO_SEED).rand(2, *OUTPUT_HW, 3).astype(np.float32)
    out = {}
    for spec in [("tiny", d) for d in DECODER_NAMES] + [("full", r) for r in ZOO_RESNETS]:
        kind, name = spec
        model, params = (_zoo_model(None, tiny_decoder=name) if kind == "tiny"
                         else _zoo_model(name))
        label = (f"mobilenet(tiny)-{name}" if kind == "tiny" else
                 name if isinstance(name, str) else f"{name[0]}-nnconv5-skip{name[1]}-bottleneck")
        fn, p = compile_forward(model, params, batch_size=2, image_size=OUTPUT_HW,
                                device="cuda")
        got = fn(p, torch.from_numpy(x).cuda()).cpu().numpy()
        out[label] = _zoo_err(got, _cpu_forward(model, params, x), label)
        if not out[label] <= 1e-3:
            fail(f"zoo sweep {label}: the card disagrees with the CPU: {out[label]}")
        del fn, p
    worst = max(out, key=out.get)
    print(f"zoo sweep: {len(out)} models ({len(DECODER_NAMES)} decoders, {len(ZOO_RESNETS)} "
          f"ResNets), b2 f32 224x224, card vs CPU max|diff| / max(1, max|cpu|) <= "
          f"{out[worst]:.3e} ({worst}; bound 1e-3)")
    return out


def zoo_phase(card: dict) -> dict:
    """The rest of the model zoo on the card (random seeded weights: no
    trained zoo weights exist in the repo): :func:`_zoo_flagship`,
    :func:`_zoo_mobilenet_nnconv5`, :func:`_zoo_sweep`."""
    out, seconds = {}, {}
    for name, part in (("resnet50_upproj", lambda: _zoo_flagship(card)),
                       ("mobilenet_nnconv5", lambda: _zoo_mobilenet_nnconv5(card)),
                       ("sweep", _zoo_sweep)):
        t0 = time.perf_counter()
        out[name] = part()
        seconds[name] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"zoo: all passed in {sum(seconds.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return out


class _SeededFrames:
    """The item loader NYUDataset calls with an ``*.h5`` path: a seeded
    raw 480x640 uint8 RGB frame and f32 depth (the h5 item format), keyed
    by the file's number, in place of the h5 read (no h5py needed)."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, path: str):
        rng = np.random.RandomState(self.seed * 100003 + int(os.path.basename(path)[:-3]))
        return (rng.randint(0, 256, (480, 640, 3), dtype=np.uint8),
                rng.uniform(0.5, 10.0, (480, 640)).astype(np.float32))


class _PooledFrames:
    """``n`` :class:`_SeededFrames` frames made in bulk up front; item ``k``
    reads frame ``k % n`` (no copy).  The input phase's timed runs read
    these, so that they time the augmentation paths and not the RNG (one
    seeded frame costs ~3.5 ms of GIL-held numpy on one core)."""

    def __init__(self, seed: int, n: int = 16):
        frames = _SeededFrames(seed)
        self.pool = [frames(f"{i:05d}.h5") for i in range(n)]

    def __call__(self, path: str):
        return self.pool[int(os.path.basename(path)[:-3]) % len(self.pool)]


def _seeded_split(root: str, split: str, n: int) -> str:
    """``n`` empty ``*.h5`` names under ``root/split/scene`` (from 00002:
    00001 is the holdout split's); returns the split's directory."""
    d = os.path.join(root, split, "scene")
    os.makedirs(d)
    for i in range(2, 2 + n):
        open(os.path.join(d, f"{i:05d}.h5"), "w").close()
    return os.path.join(root, split)


def _seeded_datasets(root: str):
    """NYUDataset train and val splits over empty ``*.h5`` names whose
    items are :class:`_SeededFrames`: the port's real train item path
    (random rotation, scale, crop, flip, colour jitter) and val path."""
    from fastdepth_tpu_torch.data import NYUDataset

    return [NYUDataset(_seeded_split(root, split, n), split=split,
                       loader=_SeededFrames(seed), seed=0)
            for split, n, seed in (("train", TRAIN_ITEMS, 1), ("val", VAL_ITEMS, 2))]


def _host_state(state) -> dict:
    """A train state's params and momentum as f64 CPU copies, by key."""
    flat = {k: v.detach().double().cpu().clone() for k, v in state.params.state_dict().items()}
    flat.update({"momentum." + k: v.double().cpu().clone() for k, v in state.momentum.items()})
    return flat


def _max_diff(a: dict, b: dict, keys) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in keys)


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms, for the checks that compare two
    runs of one step on the card (the main path keeps the defaults:
    weight-gradient algorithms may add in a varying order)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _split_keys(state: dict):
    """A :func:`_host_state`'s keys: (trainable, running statistics,
    momentum)."""
    mom = [k for k in state if k.startswith("momentum.")]
    stats = [k for k in state if k.endswith((".bn.mean", ".bn.var")) and k not in mom]
    return [k for k in state if k not in mom and k not in stats], stats, mom


def _step_card_vs_cpu(label: str, model, params, x, d, tc) -> dict:
    """One f32 SGD step on the card and on the CPU from one tree and batch
    (host tensors ``x``, ``d``), and an f64 CPU step as the momentum's
    reference: the loss within rtol 1e-4, every parameter and running
    statistic within 1e-4, the momentum (the gradient, ill-conditioned in
    f32) within 4x of the CPU f32 step's own distance to the f64 step."""
    import copy

    from fastdepth_tpu_torch.train import sgd_init
    from fastdepth_tpu_torch.train.trainer import make_train_step

    states, losses, seconds = {}, {}, {}
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu_f64", "cpu", torch.float64)):
        t0 = time.perf_counter()
        st = sgd_init(copy.deepcopy(params).to(device=dev, dtype=dtype))
        st, loss = make_train_step(model, tc)(st, x.to(dev, dtype), d.to(dev, dtype), tc.lr)
        states[name], losses[name] = _host_state(st), float(loss)
        seconds[name] = time.perf_counter() - t0
    trainable, stats, mom = _split_keys(states["card"])
    a, b, ref = states["card"], states["cpu"], states["cpu_f64"]
    row = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
           "loss_rel_diff": abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"]),
           "params_max_abs_diff": _max_diff(a, b, trainable),
           "stats_max_abs_diff": _max_diff(a, b, stats),
           "params_max_abs": max(float(b[k].abs().max()) for k in trainable),
           "stats_max_abs": max(float(b[k].abs().max()) for k in stats),
           "momentum_card_vs_f64": _max_diff(a, ref, mom),
           "momentum_cpu_vs_f64": _max_diff(b, ref, mom),
           "momentum_card_vs_cpu": _max_diff(a, b, mom),
           "momentum_max_abs": max(float(ref[k].abs().max()) for k in mom),
           "seconds": seconds}
    print(f"{label} card vs CPU, one f32 step b{x.shape[0]} lr {tc.lr}: {json.dumps(row)}")
    if not (row["loss_rel_diff"] <= 1e-4 and row["params_max_abs_diff"] <= 1e-4
            and row["stats_max_abs_diff"] <= 1e-4
            and row["momentum_card_vs_f64"] <= 4 * row["momentum_cpu_vs_f64"]):
        fail(f"{label}: the train step on the card disagrees with the CPU: {row}")
    return row


def train_phase(model, params) -> dict:
    """The training path on the flagship at 224x224, fine-tuning the
    committed weights (unfolded: BatchNorm trains):
    - one f32 step at batch 8 on the card and on the CPU from one tree and
      batch (seeded frames through the real train item path): loss within
      rtol 1e-4, every parameter and running statistic within 1e-4; the
      momentum (the gradient, ill-conditioned in f32) within 4x of the CPU
      f32 step's own distance to an f64 CPU step;
    - 10 f32 steps on a fixed batch lower the loss;
    - a checkpoint round trip: restore gives params, momentum and step back
      bit for bit, and the next step from it matches the live next step
      within 1e-5 (cuDNN's deterministic algorithms for both);
    - remat within 1e-4 of the plain step; accum_steps=2 finite, with the
      running statistics of two sequential microbatch merges;
    - cli.train.train_loop for 2 epochs of 4 steps in f32, then bf16: every
      loss finite, validate() after each epoch with K1 launched 5 times and
      K4 once a forward (counts set to 0 just before, read just after),
      finite metrics, a checkpoint.npz that restores;
    - the median step time (forward, backward, update, merge; CUDA events,
      10 steps after 3) and frames/s at b8 and b128, f32 and bf16, and the
      peak memory at b128."""
    import copy

    from fastdepth_tpu_torch import BatchLoader, build
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint, save_train_checkpoint
    from fastdepth_tpu_torch.cli import train as train_cli
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.models import layers as L
    from fastdepth_tpu_torch.train import Trainer, sgd_init
    from fastdepth_tpu_torch.train.trainer import make_train_step

    out = {}
    tc = TrainConfig(lr=TRAIN_LR, weight_decay=1e-4)
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = _seeded_datasets(os.path.join(tmp, "nyudepthv2"))
        rgb, depth, _ = next(iter(BatchLoader(train_ds, batch_size=BATCH, shuffle=True,
                                              drop_last=True, pad_last=False, num_workers=4)))
        x, d = torch.from_numpy(rgb), torch.from_numpy(depth)

        out["card_vs_cpu"] = _step_card_vs_cpu("train", model, params, x, d, tc)

        # the loss falls on a fixed batch
        xc, dc = x.cuda(), d.cuda()
        tr = Trainer(model, params, tc, device="cuda")
        first = float(tr._step(tr.state, xc, dc, TRAIN_LR)[1])
        for _ in range(9):
            tr.state, loss = tr._step(tr.state, xc, dc, TRAIN_LR)
        last = float(loss)
        print(f"train f32 b{BATCH}: loss {first:.5f} -> {last:.5f} over 10 steps on one batch")
        if not last < first:
            fail(f"10 f32 train steps did not lower the loss: {first} -> {last}")
        out["loss_10_steps"] = [first, last]

        # checkpoint round trip, remat, accumulation
        with _deterministic():
            path = os.path.join(tmp, "checkpoint.npz")
            save_train_checkpoint(path, tr.state, model.config, epoch=0)
            tree, cfg, _ = load_train_checkpoint(path)
            tr2 = Trainer(build(cfg), params, tc, device="cuda")
            tr2.restore(tree)
            live, back = _host_state(tr.state), _host_state(tr2.state)
            if (int(tr2.state.step) != int(tr.state.step)
                    or any(not torch.equal(live[k], back[k]) for k in live)):
                fail("restore did not give back params, momentum and step bit for bit")
            tr.state, _ = tr._step(tr.state, xc, dc, TRAIN_LR)
            tr2.state, _ = tr2._step(tr2.state, xc, dc, TRAIN_LR)
            resume_err = _max_diff(_host_state(tr.state), _host_state(tr2.state), list(live))
            runs = {}
            for name, kw in (("plain", {}), ("remat", {"remat": True}),
                             ("accum", {"accum_steps": 2})):
                st = sgd_init(copy.deepcopy(params).cuda())
                st, loss = make_train_step(model, tc, **kw)(st, xc, dc, TRAIN_LR)
                runs[name] = (float(loss), _host_state(st))
            remat_err = _max_diff(runs["plain"][1], runs["remat"][1], list(runs["plain"][1]))
            stats = _split_keys(runs["plain"][1])[1]
            manual = copy.deepcopy(params).cuda()
            for i in range(2):
                rec = {}
                model.apply(manual, xc[i * BATCH // 2:(i + 1) * BATCH // 2], train=True,
                            stats=rec)
                L.merge_stats(manual, rec)
            want = {k: v.double().cpu() for k, v in manual.state_dict().items()}
            accum_stats_err = _max_diff(want, runs["accum"][1], stats)
            accum_finite = np.isfinite(runs["accum"][0]) and all(
                torch.isfinite(v).all() for v in runs["accum"][1].values())
        row = {"restored_bit_for_bit": True, "next_step_max_abs_diff": resume_err,
               "remat_max_abs_diff": remat_err, "accum_loss": runs["accum"][0],
               "accum_stats_max_abs_diff": accum_stats_err}
        print(f"train checkpoint / remat / accum (cuDNN deterministic): {json.dumps(row)}")
        if not resume_err <= 1e-5:
            fail(f"the step after restore differs from the live one by {resume_err}")
        if not remat_err <= 1e-4:
            fail(f"remat differs from the plain step by {remat_err}")
        if not (accum_finite and accum_stats_err <= 1e-5):
            fail(f"accum_steps=2: finite {accum_finite}, running statistics "
                 f"{accum_stats_err} from two sequential merges")
        out.update(row)

        # the CLI's epoch loop, f32 then bf16
        val_forwards = -(-VAL_ITEMS // BATCH) + 1  # validate() warms up on its first batch
        for name, extra in (("f32", []), ("bf16", ["--bf16"])):
            out_dir = os.path.join(tmp, f"run_{name}")
            args = train_cli.parse_args(
                ["--epochs", str(TRAIN_EPOCHS), "--batch-size", str(BATCH), "--eval-batch-size",
                 str(BATCH), "--workers", "4", "--print-freq", "0", "--output-dir", out_dir,
                 "--lr", str(TRAIN_LR), "--device", "cuda"] + extra)
            log = io.StringIO()
            _reset("K1", "K4", "K7")
            with contextlib.redirect_stdout(log):
                # no comparison PNGs: they need matplotlib
                best = train_cli.train_loop(args, model, params, train_ds, val_ds,
                                            make_images=False)
            torch.cuda.synchronize()
            k1, k4, k7 = _counts("K1", "K4", "K7")
            epochs = re.findall(r"=> epoch (\d+): train loss ([-\w.]+)", log.getvalue())
            print(f"train_loop {name}: epochs {epochs}; validate RMSE {best.rmse:.4f} delta1 "
                  f"{best.delta1:.4f}; K1 {k1}, K4 {k4}, K7 {k7} launches")
            forwards = TRAIN_EPOCHS * val_forwards
            if (k1, k4) != (STAGES_PER_FORWARD * forwards, forwards):
                fail(f"train_loop {name}: K1 launched {k1} and K4 {k4} times over {forwards} "
                     f"validation forwards, want {STAGES_PER_FORWARD} and 1 per forward")
            # the train steps run no K7: training keeps the separate ops
            _check_k7(f"train_loop {name}", k7, forwards)
            losses = [float(v) for _, v in epochs]
            if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)):
                fail(f"train_loop {name}: epoch losses {losses}")
            if not all(np.isfinite([best.rmse, best.mae, best.delta1, best.absrel])):
                fail(f"train_loop {name}: validation metrics not finite: {best.rmse}")
            tree, _, meta = load_train_checkpoint(os.path.join(out_dir, "checkpoint.npz"))
            tr3 = Trainer(model, params, tc, device="cuda")
            tr3.restore(tree)
            steps = TRAIN_EPOCHS * (TRAIN_ITEMS // BATCH)
            if meta["epoch"] != TRAIN_EPOCHS - 1 or int(tr3.state.step) != steps:
                fail(f"train_loop {name}: checkpoint at epoch {meta['epoch']}, step "
                     f"{int(tr3.state.step)}, want {TRAIN_EPOCHS - 1} and {steps}")
            out[f"loop_{name}"] = {"epoch_losses": losses, "rmse": best.rmse,
                                   "delta1": best.delta1, "k1_launches": k1, "k4_launches": k4,
                                   "validation_forwards": forwards}
    out["times"] = train_times(model, params)
    return out


def _kernel_time(fn):
    """The CUDA kernels of one call of ``fn``, by ``torch.profiler``: (their
    summed time in us, [(name, us)] largest first), or (None, []) where the
    profiler recorded no device activity.  Kernels of one stream do not
    overlap, so the sum is the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return None, []
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])


def train_times(model, params, batches=(BATCH, TRAIN_BIG_BATCH), card=None) -> dict:
    """Median step time (forward, backward, SGD update, statistics merge)
    over 10 steps after 3, CUDA events around each step on one seeded
    device batch, and frames/s, at each of ``batches`` in f32 and bf16;
    the peak device memory of each run; the kernel time of one more step
    (``torch.profiler``), against which the median reads as host time."""
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.train import Trainer

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for batch in batches:
        x = torch.rand(batch, *OUTPUT_HW, 3, generator=gen, device="cuda")
        d = torch.rand(batch, *OUTPUT_HW, 1, generator=gen, device="cuda") * 9.5 + 0.5
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(model, params, TrainConfig(lr=TRAIN_LR), compute_dtype=dtype,
                         device="cuda")
            for _ in range(3):
                tr.state, loss = tr._step(tr.state, x, d, TRAIN_LR)
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                tr.state, loss = tr._step(tr.state, x, d, TRAIN_LR)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            if not np.isfinite(float(loss)):
                fail(f"train timing b{batch} {name}: non-finite loss")
            ms = float(np.median(times))
            row = {"step_ms": ms, "frames_per_s": batch / ms * 1e3,
                   "step_ms_min": float(np.min(times)), "step_ms_max": float(np.max(times)),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            busy_us, top = _kernel_time(lambda: tr._step(tr.state, x, d, TRAIN_LR))
            row["kernel_ms"] = None if busy_us is None else busy_us / 1e3
            row["top_kernels_ms"] = [(k, us / 1e3) for k, us in top[:6]]
            print(f"train step {model.config.encoder}-{model.config.decoder} b{batch} {name}"
                  + (f" on {card['nvidia_smi']}" if card else "")
                  + f": median {ms:.3f} ms ({row['frames_per_s']:.1f} "
                  f"frames/s; min {row['step_ms_min']:.3f}, max {row['step_ms_max']:.3f}), peak "
                  f"memory {row['peak_mem_gib']:.2f} GiB; kernel time of one step "
                  + ("not measured (no device events traced)" if busy_us is None else
                     f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / ms:.0%} of the median step), "
                     "largest: " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in
                                             row["top_kernels_ms"])))
            out[f"b{batch}_{name}"] = row
            del tr
    return out


def _ring_check() -> dict:
    """``engine/staging.PinnedRing`` on the card with one slot: the copy of a
    first array waits behind a ~50 ms sleep on the stream, and the second
    put into the same slot must wait for that copy before it refills the
    buffer; both copies must arrive intact."""
    from fastdepth_tpu_torch.engine.staging import PinnedRing

    ring = PinnedRing("cuda", slots=1)
    a = np.full((1 << 20,), 1.0, np.float32)
    b = np.full((1 << 20,), 2.0, np.float32)
    ring.put(a)  # allocates the slot
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e7))  # ~50 ms of device cycles ahead of the copy
    t0 = time.perf_counter()
    got_a = ring.put(a)
    got_b = ring.put(b)  # must wait for got_a's copy
    waited_ms = (time.perf_counter() - t0) * 1e3
    ok = bool((got_a == 1.0).all()) and bool((got_b == 2.0).all())
    print(f"input: pinned ring, one slot, a copy held ~50 ms behind a sleep: the refill "
          f"waited {waited_ms:.1f} ms, both copies intact: {ok}")
    if not ok:
        fail("the pinned ring refilled a slot before its copy completed")
    return {"refill_wait_ms": waited_ms}


def _stack(ds, idxs):
    items = [ds[i] for i in idxs]
    return [np.stack([it[j] for it in items]) for j in range(len(items[0]))]


def _differing(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum()) if got.shape == want.shape else got.numel()


def input_phase(model, params, card: dict) -> dict:
    """The input pipeline's on-card half, on the flagship at 224x224 with
    the committed weights, over seeded raw 480x640 frames:
    - train values: ``data/device_aug.apply_train_augment`` on the card
      over b8 device-augment items, and the JAX package's dot form of it
      (``scripts/probe_r5_device_gathers.augment_dot``),
      equals the host's train items with the same seed bit for bit (rgb
      and depth), and the same form's CPU run on the same arrays;
    - train step: one f32 b8 step from the raw arrays equals the step from
      the host items bit for bit (loss, parameters, running statistics,
      momentum), cuDNN's deterministic algorithms for both;
    - train loop: cli.train.train_loop --device-augment, one epoch b8 f32,
      a finite loss;
    - eval values: ``Evaluator(val_pipeline=...)`` over raw frames against
      the host-preprocessed path at b8 in f32 (the forward's input and the
      metrics' target bit for bit, the metric rows within rtol 1e-6) and
      bf16, K1 and K4 launched 5 and 1 times a forward; metrics.evaluate
      against evaluate_batch;
    - the pinned ring's wait on the card;
    - times, over frames made up front (:class:`_PooledFrames`):
      cli.benchmark's train_run at b8 and b128, f32 and bf16, host
      against device augmentation, and eval_run at b8 f32, host against
      device preprocessing (frames/s, with the host's cores and the loader
      threads); at b128 the copy of a device-augment batch and of a host
      batch, and apply_train_augment's time against its bound;
      engine/benchmark.throughput_sweep at b1, b32 and b128."""
    import copy

    from fastdepth_tpu_torch import metrics as M
    from fastdepth_tpu_torch.cli import benchmark as bench_cli
    from fastdepth_tpu_torch.cli import train as train_cli
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.data import BatchLoader, NYUDataset
    from fastdepth_tpu_torch.data.device_aug import apply_train_augment
    from fastdepth_tpu_torch.engine import Evaluator, validate
    from fastdepth_tpu_torch.engine import evaluator as E
    from fastdepth_tpu_torch.engine.benchmark import bound_us, throughput_sweep, time_pipelined
    from fastdepth_tpu_torch.engine.staging import PinnedRing
    from fastdepth_tpu_torch.scripts import probe_r5_device_gathers
    from fastdepth_tpu_torch.train import sgd_init
    from fastdepth_tpu_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    out = {}
    where = (f"on {card['nvidia_smi']}, os.cpu_count() {os.cpu_count()}, "
             f"-j {INPUT_WORKERS}")
    with tempfile.TemporaryDirectory() as tmp:
        seeded, pooled = _SeededFrames(3), _PooledFrames(3)

        def split(name, n, frames=seeded, **kw):
            """The ``name`` split's ``n`` seeded items."""
            return NYUDataset(os.path.join(tmp, f"{name}_{n}", name), split=name,
                              loader=frames, seed=0, **kw)

        for n in sorted(set(INPUT_TRAIN_ITEMS.values())):
            _seeded_split(os.path.join(tmp, f"train_{n}"), "train", n)
        _seeded_split(os.path.join(tmp, f"val_{INPUT_VAL_ITEMS}"), "val", INPUT_VAL_ITEMS)
        small = INPUT_TRAIN_ITEMS[BATCH]
        host_ds, aug_ds = split("train", small), split("train", small, device_augment=True)

        # train values: the card's augmentation, and the JAX package's dot
        # form of it that the device-augment probe times, against the host
        # items and against the same form's CPU run
        idxs = list(range(BATCH))
        raw = _stack(aug_ds, idxs)
        x_host, d_host = (torch.from_numpy(a) for a in _stack(host_ds, idxs))
        raw_cuda = [torch.from_numpy(a).cuda() for a in raw]
        out["train_values_differing"] = {}
        for form, augment in (("dot", probe_r5_device_gathers.augment_dot),
                              ("gather", apply_train_augment)):
            rgb_c, depth_c = augment(*raw_cuda, out_size=OUTPUT_HW)
            rgb_cpu, depth_cpu = augment(*[torch.from_numpy(a) for a in raw],
                                         out_size=OUTPUT_HW)
            rgb_c, depth_c = rgb_c.cpu(), depth_c.cpu()
            n_vals = rgb_c.numel() + depth_c.numel()
            vs_host = _differing(rgb_c, x_host) + _differing(depth_c, d_host)
            vs_cpu = _differing(rgb_c, rgb_cpu) + _differing(depth_c, depth_cpu)
            print(f"input train values b{BATCH}: the augmentation's {form} form on the "
                  f"card vs the host's train items: {vs_host} of {n_vals} values differ (bound "
                  f"0); vs its CPU run: {vs_cpu} of {n_vals} differ (bound 0)")
            if vs_host or vs_cpu:
                fail(f"device augmentation ({form}) differs from the host items on {vs_host} "
                     f"values and from its CPU run on {vs_cpu}")
            out["train_values_differing"][form] = {"host": vs_host, "cpu": vs_cpu, "of": n_vals}

        # train step: raw arrays against host items, one f32 step each
        tc = TrainConfig(lr=TRAIN_LR, weight_decay=1e-4)
        with _deterministic():
            s_h, l_h = make_train_step(model, tc)(sgd_init(copy.deepcopy(params).cuda()),
                                                  x_host.cuda(), d_host.cuda(), TRAIN_LR)
            s_d, l_d = make_train_step(model, tc, device_augment=True)(
                sgd_init(copy.deepcopy(params).cuda()), *raw_cuda, TRAIN_LR)
            a, b = _host_state(s_h), _host_state(s_d)
        trainable, stats, mom = _split_keys(a)
        unequal = {name: sum(not torch.equal(a[k], b[k]) for k in keys)
                   for name, keys in (("params", trainable), ("stats", stats), ("momentum", mom))}
        row = {"loss_host_items": float(l_h), "loss_device_augment": float(l_d),
               "unequal_tensors": unequal, "of": {"params": len(trainable),
                                                  "stats": len(stats), "momentum": len(mom)}}
        print(f"input train step f32 b{BATCH} (cuDNN deterministic), device augmentation vs "
              f"host items: {json.dumps(row)} (bound: bit for bit)")
        if float(l_h) != float(l_d) or any(unequal.values()):
            fail(f"the device-augment step differs from the host-item step: {row}")
        out["train_step"] = row

        # the CLI's epoch loop with --device-augment, one epoch
        with tempfile.TemporaryDirectory() as run_dir:
            args = train_cli.parse_args(
                ["--epochs", "1", "--batch-size", str(BATCH), "--eval-batch-size", str(BATCH),
                 "--workers", "4", "--print-freq", "0", "--output-dir", run_dir,
                 "--lr", str(TRAIN_LR), "--device", "cuda", "--device-augment"])
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                best = train_cli.train_loop(args, model, params, aug_ds.take(TRAIN_ITEMS),
                                            split("val", INPUT_VAL_ITEMS).take(VAL_ITEMS),
                                            make_images=False)
        losses = [float(v) for v in re.findall(r"=> epoch \d+: train loss ([-\w.]+)",
                                                 log.getvalue())]
        print(f"input train_loop --device-augment b{BATCH} f32, 1 epoch of "
              f"{TRAIN_ITEMS // BATCH} steps: losses {losses}, validate RMSE {best.rmse:.4f}")
        if len(losses) != 1 or not np.isfinite(losses[0]) or not np.isfinite(best.rmse):
            fail(f"train_loop --device-augment: losses {losses}, RMSE {best.rmse}")
        out["train_loop_losses"] = losses

        # eval values: the gather on the card against the host path
        val_host = split("val", INPUT_VAL_ITEMS)
        val_raw = split("val", INPUT_VAL_ITEMS, raw_items=True)
        host_loader = BatchLoader(val_host.take(2 * BATCH), batch_size=BATCH, num_workers=4,
                                  pad_last=True)
        raw_loader = BatchLoader(val_raw.take(2 * BATCH), batch_size=BATCH, num_workers=4,
                                 pad_last=True)
        forwards = 2 + 1  # validate() warms up on its first batch
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ev_h = Evaluator(model, params, batch_size=BATCH, dtype=dtype, device="cuda")
            ev_d = Evaluator(model, params, batch_size=BATCH, dtype=dtype, device="cuda",
                             val_pipeline=val_raw.val_pipeline)
            _reset("K1", "K4", "K7")
            avg_d = validate(raw_loader, ev_d, print_freq=0, make_images=False,
                             log=lambda s: None)
            torch.cuda.synchronize()
            k1, k4, k7 = _counts("K1", "K4", "K7")
            _check_k7(f"device preprocessing {name}", k7, forwards)
            avg_h = validate(host_loader, ev_h, print_freq=0, make_images=False,
                             log=lambda s: None)
            if (k1, k4) != (STAGES_PER_FORWARD * forwards, forwards):
                fail(f"device preprocessing {name}: K1 launched {k1} and K4 {k4} times over "
                     f"{forwards} forwards, want {STAGES_PER_FORWARD} and 1 per forward")
            # one batch through both, recording the forward's input and the
            # metrics' target
            seen = {"h": [], "d": []}
            rgb_r, depth_r, _ = next(iter(raw_loader))
            rgb_p, depth_p, _ = next(iter(host_loader))
            rows = {}
            batch_metrics = M.evaluate_batch
            for key, ev, (r, d) in (("h", ev_h, (rgb_p, depth_p)), ("d", ev_d, (rgb_r, depth_r))):
                forward = ev._apply

                def record(p, x, forward=forward, key=key):
                    seen[key].append(x.clone())
                    return forward(p, x)

                def metrics(pred, target, *group, key=key):
                    seen[key].append(target.clone())
                    return batch_metrics(pred, target, *group)

                ev._apply, E.M.evaluate_batch = record, metrics
                try:
                    pred, rows[key] = ev(ev.put(r), ev.put(d))
                finally:
                    ev._apply, E.M.evaluate_batch = forward, batch_metrics
            torch.cuda.synchronize()
            in_diff = sum(_differing(g, w) for g, w in zip(seen["d"], seen["h"]))
            # relative to the host row; equal entries (an infinite iRMSE on
            # a zero prediction too) differ by 0
            rel = float(torch.where(rows["d"] == rows["h"], 0.0,
                                    (rows["d"] - rows["h"]).abs() / rows["h"].abs()).max())
            row = {"k1_launches": k1, "k4_launches": k4, "forwards": forwards,
                   "input_values_differing": in_diff, "metric_rows_max_rel_diff": rel,
                   "validate_rmse_host": avg_h.rmse, "validate_rmse_device": avg_d.rmse}
            print(f"input eval {name} b{BATCH}, device preprocessing vs the host path: "
                  f"{json.dumps(row)}")
            if name == "f32" and (in_diff or not rel <= 1e-6):
                fail(f"device preprocessing f32: {in_diff} input values differ, metric rows "
                     f"{rel} apart (bound 0 and rtol 1e-6)")
            if not np.isfinite(avg_d.rmse):
                fail(f"device preprocessing {name}: RMSE {avg_d.rmse}")
            out[f"eval_{name}"] = row
            if name == "f32":
                single = M.evaluate(pred[0], depth_p[0])
                want = M.evaluate_batch(pred[:1], ev_h.put(depth_p[:1]))
                got = np.array([getattr(single, k) for k in M.METRIC_FIELDS])
                ref = np.array([float(want[k][0]) for k in M.METRIC_FIELDS])
                same = bool(np.array_equal(got, ref, equal_nan=True))
                print(f"input metrics.evaluate vs evaluate_batch on one frame: equal {same}")
                if not same:
                    fail(f"metrics.evaluate {got} differs from evaluate_batch {ref}")
        out["ring"] = _ring_check()
        t_checks = time.perf_counter() - t_phase

        # times: the streaming CLIs' run functions, host against device
        times = {}
        for batch in (BATCH, TRAIN_BIG_BATCH):
            n = INPUT_TRAIN_ITEMS[batch]
            for dt, extra in (("f32", []), ("bf16", ["--bf16"])):
                for mode in ("host", "device"):
                    args = bench_cli.parse_args(
                        ["--train", "--batch-size", str(batch), "-j", str(INPUT_WORKERS),
                         "--device", "cuda", "--json"] + extra
                        + (["--device-augment"] if mode == "device" else []))
                    ds = split("train", n, pooled, device_augment=mode == "device")
                    with contextlib.redirect_stdout(io.StringIO()):
                        r = bench_cli.train_run(ds, model, params, args)
                    times[f"train_b{batch}_{dt}_{mode}"] = r
                    print(f"input train_run b{batch} {dt} {mode} augmentation {where}: "
                          f"{r['fps']:.1f} train frames/s ({r['frames']} frames in "
                          f"{r['elapsed_s']:.3f} s, loss {r['final_loss']:.4f})")
                    if not np.isfinite(r["final_loss"]):
                        fail(f"train_run b{batch} {dt} {mode}: loss {r['final_loss']}")
        for mode in ("host", "device"):
            args = bench_cli.parse_args(
                ["--batch-size", str(BATCH), "-j", str(INPUT_WORKERS), "--device", "cuda",
                 "--json"] + (["--device-preprocess"] if mode == "device" else []))
            ds = split("val", INPUT_VAL_ITEMS, pooled, raw_items=mode == "device",
                       device_normalize=True)
            with contextlib.redirect_stdout(io.StringIO()):
                r = bench_cli.eval_run(ds, model, params, args)
            times[f"eval_b{BATCH}_f32_{mode}"] = r
            print(f"input eval_run b{BATCH} f32 {mode} preprocessing {where}: "
                  f"{r['fps']:.1f} frames/s ({r['frames']} frames in {r['elapsed_s']:.3f} s)")

        # where the streamed time goes: one item on one thread, the loader
        # alone, and validate() over batches already in memory (wall time,
        # kernel time, and the host functions that take the most of it)
        big = TRAIN_BIG_BATCH
        attrib = {}
        for name, b, ds in (
                ("train_host", big, split("train", INPUT_TRAIN_ITEMS[big], pooled)),
                ("train_device_augment", big,
                 split("train", INPUT_TRAIN_ITEMS[big], pooled, device_augment=True)),
                ("val_host", BATCH, split("val", INPUT_VAL_ITEMS, pooled, device_normalize=True)),
                ("val_raw", BATCH, split("val", INPUT_VAL_ITEMS, pooled, raw_items=True))):
            t0 = time.perf_counter()
            for i in range(BATCH):
                ds[i]
            item_ms = (time.perf_counter() - t0) / BATCH * 1e3
            loader = BatchLoader(ds.take(2 * big), batch_size=b, num_workers=INPUT_WORKERS,
                                 drop_last=True, pad_last=False)
            t0 = time.perf_counter()
            n = sum(batch[-1] for batch in loader)
            attrib[name] = {"item_ms_one_thread": item_ms,
                            "loader_items_per_s": n / (time.perf_counter() - t0)}
            print(f"input {name} items {where}: {item_ms:.2f} ms an item on one thread; the "
                  f"loader alone (b{b}) {attrib[name]['loader_items_per_s']:.1f} items/s")
        mem = _Frames(list(BatchLoader(split("val", INPUT_VAL_ITEMS, pooled, device_normalize=True),
                                       batch_size=BATCH, num_workers=INPUT_WORKERS)))
        ev = Evaluator(model, params, batch_size=BATCH, device="cuda")

        def run_validate():
            return validate(mem, ev, print_freq=0, make_images=False, log=lambda s: None)

        run_validate()
        t0 = time.perf_counter()
        avg = run_validate()
        wall = time.perf_counter() - t0
        busy_us, _ = _kernel_time(run_validate)
        prof = cProfile.Profile()
        prof.enable()
        run_validate()
        prof.disable()
        top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:8]
        attrib["validate_in_memory"] = {
            "frames_per_s": len(mem.dataset) / wall, "validate_fps": 1.0 / avg.gpu_time,
            "kernel_ms": None if busy_us is None else busy_us / 1e3, "wall_ms": wall * 1e3,
            "host_tottime_ms": [(f"{fn} ({os.path.basename(path)}:{line})", st[2] * 1e3, st[1])
                                for (path, line, fn), st in top]}
        v = attrib["validate_in_memory"]
        print(f"input validate() b{BATCH} f32 over {len(mem.dataset)} frames in memory {where}: "
              f"{v['frames_per_s']:.1f} frames/s wall ({wall * 1e3:.1f} ms), 1/gpu_time "
              f"{v['validate_fps']:.1f}; kernel time "
              + ("not measured" if busy_us is None else
                 f"{busy_us / 1e3:.2f} ms ({busy_us / 1e3 / (wall * 1e3):.0%} of the wall)")
              + "; host functions by own time under cProfile: "
              + "; ".join(f"{k} {ms:.1f} ms / {n} calls" for k, ms, n in v["host_tottime_ms"]))
        out["attribution"] = attrib

        # b128 device augmentation: the copy and the augmentation alone
        copies = {}
        for name, kw in (("device_augment", {"device_augment": True}), ("host_items", {})):
            arrays = next(iter(BatchLoader(split("train", INPUT_TRAIN_ITEMS[big], pooled, **kw),
                                           batch_size=big, num_workers=INPUT_WORKERS,
                                           drop_last=True, pad_last=False)))[:-1]
            ring = PinnedRing("cuda", slots=len(arrays))
            for a in arrays:  # allocate the slots
                ring.put(a)
            pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
            torch.cuda.synchronize()
            row = {"bytes": sum(a.nbytes for a in arrays)}
            # put: the staging memcpy on the host and the copy; dma: the copy
            # from page-locked memory alone
            for key, run in (("put_ms", lambda: [ring.put(a) for a in arrays]),
                             ("dma_ms", lambda: [t.to("cuda", non_blocking=True)
                                                 for t in pinned])):
                ms = []
                for _ in range(3):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    dev = run()
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                row[key] = float(np.median(ms))
            row["dma_gb_per_s"] = row["bytes"] / row["dma_ms"] / 1e6
            copies[name] = row
            if name == "device_augment":
                aug_args = tuple(dev)
        aug_ms = time_pipelined(lambda *a: apply_train_augment(*a, out_size=OUTPUT_HW),
                                aug_args, warmup=2, calls=5)["mean_s"] * 1e3
        px = OUTPUT_HW[0] * OUTPUT_HW[1]
        # gathered u8 rgb and f32 depth, the int32 map, the f32 rgb and depth
        # written; the scale, kinds and the few looked-up table entries aside
        aug_bytes = big * px * (3 + 4 + 4 + 12 + 4)
        aug_bound_us, aug_by = bound_us(aug_bytes)
        step_ms = (times[f"train_b{big}_f32_device"]["elapsed_s"] * 1e3
                   / (times[f"train_b{big}_f32_device"]["frames"] / big))
        row = {"copy": copies, "augment_ms": aug_ms, "augment_bound_ms": aug_bound_us / 1e3,
               "augment_bound_by": aug_by, "augment_bytes": aug_bytes,
               "streamed_step_ms_f32": step_ms,
               "copy_share_of_streamed_step": copies["device_augment"]["put_ms"] / step_ms}
        c, h = copies["device_augment"], copies["host_items"]
        print(f"input b{big} device augmentation {where}: a batch of {c['bytes']} B: put "
              f"(staging memcpy + copy) {c['put_ms']:.3f} ms, copy alone {c['dma_ms']:.3f} ms "
              f"({c['dma_gb_per_s']:.1f} GB/s); host items ({h['bytes']} B): put "
              f"{h['put_ms']:.3f} ms, copy {h['dma_ms']:.3f} ms; the put is "
              f"{row['copy_share_of_streamed_step']:.1%} of the streamed f32 step "
              f"({step_ms:.3f} ms); apply_train_augment {aug_ms:.3f} ms (events, 5 calls) "
              f"against a bound of {aug_bound_us / 1e3:.4f} ms ({aug_by}, {aug_bytes} B)")
        out["b128"] = row

        sweep = throughput_sweep(model, model.fold(params), batch_sizes=(1, 32, 128),
                                 warmup=2, calls=10)
        for b, r in sweep.items():
            print(f"input throughput_sweep b{b} f32 (straight folded forward) {where}: "
                  f"{r['fps']:.1f} frames/s ({r['mean_s'] * 1e3:.3f} ms a call)")
        out["sweep"] = sweep
        out["times"] = times
    torch.cuda.empty_cache()
    print(f"input: all passed in {time.perf_counter() - t_phase:.1f} s (the checks "
          f"{t_checks:.1f} s)")
    return out


MESH_BIG_BATCH = TRAIN_BIG_BATCH  # the b128 bf16 step
MESH_TIMED, MESH_WARMUP = 10, 3
MESH_CLI_TRAIN, MESH_CLI_VAL = 2 * BATCH, BATCH  # cli.train: 2 steps, 1 val batch
MESH_CLI_LR = 1e-5  # the port's f32 CLI comparisons train at a small lr


@contextlib.contextmanager
def _count_collectives():
    """Counts the process-group collectives issued inside (all_reduce and
    all_gather: the only two the port's mesh path calls)."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    for name in counts:
        setattr(dist, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _mesh_step_check(label: str, model, params, x, d, tc, mesh, **kw) -> dict:
    """One step with the mesh, one without (f32, same tree and batch, cuDNN
    deterministic) and an f64 step on the card as the momentum's
    reference: the train phase's bounds (loss rtol 1e-4; parameters and
    running statistics 1e-4; the momentum within 4x of the no-mesh f32
    step's own distance to the f64 one)."""
    import copy

    from fastdepth_tpu_torch.train import sgd_init
    from fastdepth_tpu_torch.train.trainer import make_train_step

    states, losses = {}, {}
    with _deterministic():
        for name, dtype, m in (("mesh", torch.float32, mesh), ("plain", torch.float32, None),
                               ("f64", torch.float64, None)):
            st = sgd_init(copy.deepcopy(params).to(device="cuda", dtype=dtype))
            st, loss = make_train_step(model, tc, mesh=m, **kw)(
                st, x.to(dtype), d.to(dtype), tc.lr)
            states[name], losses[name] = _host_state(st), float(loss)
    trainable, stats, mom = _split_keys(states["plain"])
    a, b, ref = states["mesh"], states["plain"], states["f64"]
    row = {"loss_mesh": losses["mesh"], "loss_plain": losses["plain"],
           "loss_rel_diff": abs(losses["mesh"] - losses["plain"]) / abs(losses["plain"]),
           "params_max_abs_diff": _max_diff(a, b, trainable),
           "stats_max_abs_diff": _max_diff(a, b, stats),
           "momentum_mesh_vs_f64": _max_diff(a, ref, mom),
           "momentum_plain_vs_f64": _max_diff(b, ref, mom)}
    print(f"mesh {label}: {json.dumps(row)}")
    if not (row["loss_rel_diff"] <= 1e-4 and row["params_max_abs_diff"] <= 1e-4
            and row["stats_max_abs_diff"] <= 1e-4
            and row["momentum_mesh_vs_f64"] <= 4 * row["momentum_plain_vs_f64"]):
        fail(f"mesh {label}: the step over the mesh disagrees with the step without: {row}")
    return row


def _event_ms(fn) -> float:
    """Median of MESH_TIMED calls of ``fn`` after MESH_WARMUP, CUDA events
    around each call (host launch time included)."""
    for _ in range(MESH_WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(MESH_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _mesh_times(model, params, mesh, card: dict) -> dict:
    """The mesh's cost at world size 1, in turns (plain, mesh, mesh, plain)
    inside this call: the train step at b8 f32 and b128 bf16, and the
    eval step at b8 f32 (forward, metrics and the metric fetch: the
    mesh's all-gather), each the median of 10 after 3; and the
    collectives one step issues."""
    from fastdepth_tpu_torch import Evaluator
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.train import Trainer

    import torch.distributed as dist

    out = {}
    small = torch.ones(64, device="cuda")

    def hundred_all_reduces():
        for _ in range(100):
            dist.all_reduce(small, group=mesh.group)

    # host clock around 100 calls and a sync: a collective's cost as the
    # step pays it (launch and bookkeeping; the kernel is a copy at world 1)
    us = []
    for _ in range(MESH_WARMUP + MESH_TIMED):
        t0 = time.perf_counter()
        hundred_all_reduces()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e4)
    out["all_reduce_64_us"] = float(np.median(us[MESH_WARMUP:]))
    print(f"mesh: one all-reduce of 64 floats {out['all_reduce_64_us']:.1f} us on "
          f"{card['nvidia_smi']} (median of {MESH_TIMED} runs of 100 calls)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    for batch, name, dtype in ((BATCH, "f32", None), (MESH_BIG_BATCH, "bf16", torch.bfloat16)):
        x = torch.rand(batch, *OUTPUT_HW, 3, generator=gen, device="cuda")
        d = torch.rand(batch, *OUTPUT_HW, 1, generator=gen, device="cuda") * 9.5 + 0.5
        trainers = {m: Trainer(model, params, TrainConfig(lr=TRAIN_LR), compute_dtype=dtype,
                               mesh=mesh if m == "mesh" else None,
                               device=None if m == "mesh" else "cuda")
                    for m in ("plain", "mesh")}

        def run(m):
            tr = trainers[m]
            tr.state, _ = tr._step(tr.state, x, d, TRAIN_LR)

        ms = {"plain": [], "mesh": []}
        for m in ("plain", "mesh", "mesh", "plain"):
            ms[m].append(_event_ms(lambda: run(m)))
        with _count_collectives() as calls:
            run("mesh")
        torch.cuda.synchronize()
        row = {"plain_ms": ms["plain"], "mesh_ms": ms["mesh"],
               "mesh_over_plain": float(np.mean(ms["mesh"]) / np.mean(ms["plain"])),
               "collectives_per_step": dict(calls)}
        print(f"mesh train step b{batch} {name} on {card['nvidia_smi']}: {json.dumps(row)}")
        out[f"train_b{batch}_{name}"] = row
        del trainers
        torch.cuda.empty_cache()

    x = torch.rand(BATCH, *OUTPUT_HW, 3, generator=gen, device="cuda")
    d = torch.rand(BATCH, *OUTPUT_HW, 1, generator=gen, device="cuda") * 9.5 + 0.5
    evs = {m: Evaluator(model, params, batch_size=BATCH, mesh=mesh if m == "mesh" else None,
                        device=None if m == "mesh" else "cuda") for m in ("plain", "mesh")}

    def eval_step(m):
        evs[m].fetch(evs[m](x, d)[1], dim=1)  # the fetch is the sync

    ms = {"plain": [], "mesh": []}
    for m in ("plain", "mesh", "mesh", "plain"):
        for _ in range(MESH_WARMUP):
            eval_step(m)
        times = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            eval_step(m)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[m].append(float(np.median(times)))
    with _count_collectives() as calls:
        eval_step("mesh")
    row = {"plain_ms": ms["plain"], "mesh_ms": ms["mesh"],
           "mesh_over_plain": float(np.mean(ms["mesh"]) / np.mean(ms["plain"])),
           "collectives_per_step": dict(calls), "clock": "host, ends with the metric fetch"}
    print(f"mesh eval step b{BATCH} f32 on {card['nvidia_smi']}: {json.dumps(row)}")
    out[f"eval_b{BATCH}_f32"] = row
    return out


def _mesh_clis(model, params, tmp: str) -> dict:
    """cli.train (one epoch, resumed from the committed weights) and
    cli.evaluate over its model_best.npz, each with --mesh-devices 1 and
    without, on seeded frames and without PNGs (parallel/dryrun's
    seeded_frames, without_train_images: the card machine has no h5py and
    no matplotlib); their CSVs and checkpoints compared by
    parallel/dryrun.compare within the train step's 1e-4.  Then
    --mesh-devices 2 must exit up front, naming the one card."""
    from fastdepth_tpu_torch.checkpoint.io import save_train_checkpoint
    from fastdepth_tpu_torch.cli import evaluate as eval_cli
    from fastdepth_tpu_torch.cli import train as train_cli
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.parallel import dryrun as DR
    from fastdepth_tpu_torch.train import Trainer

    root = os.path.join(tmp, "data")
    for split, n in (("train", MESH_CLI_TRAIN), ("val", MESH_CLI_VAL)):
        _seeded_split(os.path.join(root, "nyudepthv2"), split, n)
    start = os.path.join(tmp, "start.npz")  # epoch -1: the CLI resumes at epoch 0
    save_train_checkpoint(start, Trainer(model, params, TrainConfig(), device="cuda").state,
                          model.config, epoch=-1)
    outs = {}
    for name, extra in (("plain", []), ("mesh1", ["--mesh-devices", "1"])):
        out = outs[name] = os.path.join(tmp, name)
        with DR.seeded_frames(), DR.without_train_images(), contextlib.redirect_stdout(
                io.StringIO()):
            train_cli.main(["--data-root", root, "--resume", start, "--epochs", "1",
                            "--batch-size", str(BATCH), "--eval-batch-size", str(BATCH),
                            "--workers", "4", "--print-freq", "0", "--lr", str(MESH_CLI_LR),
                            "--output-dir", out, "--device", "cuda", *extra])
            eval_cli.main(["--evaluate", os.path.join(out, "model_best.npz"), "--data-root",
                           root, "--batch-size", str(BATCH), "--print-freq", "0",
                           "--no-images", "--csv", os.path.join(out, "eval.csv"),
                           "--device", "cuda", *extra])
    report = DR.compare(outs["plain"], outs["mesh1"], epochs=1)["checks"]
    print(f"mesh CLIs --mesh-devices 1 vs none (1 epoch at lr {MESH_CLI_LR}): "
          f"{json.dumps(report)}")
    bad = {k: v for k, v in report.items() if (v > 1e-4 if k.endswith("_rel_diff") else not v)}
    if bad:
        fail(f"the --mesh-devices 1 CLIs disagree with the runs without a mesh: {bad}")

    refused = os.path.join(tmp, "refused")
    try:
        train_cli.main(["--data-root", root, "--mesh-devices", "2", "--output-dir", refused,
                        "--device", "cuda"])
    except SystemExit as e:
        message = str(e)
    else:
        fail("cli.train --mesh-devices 2 ran on one card")
    print(f"mesh CLI --mesh-devices 2 on one card: exits with {message!r}")
    if not re.fullmatch(r"need 2 devices for the mesh, have 1", message) or os.path.exists(
            refused):
        fail(f"--mesh-devices 2 on one card: {message!r}, wrote output: "
             f"{os.path.exists(refused)}")
    return {"compare": report, "refusal": message}


def mesh_phase(model, params, card: dict) -> dict:
    """Data parallelism (parallel/) on the one card, at world size 1 over
    NCCL: the same code as more ranks, every collective issued:
    - the train step with the mesh against the step without (b8 f32,
      accum_steps 2, the train phase's bounds; b8 bf16, loss rtol 3e-3);
    - Evaluator(mesh) against Evaluator(mesh=None) over seeded val frames:
      metric rows 0 apart (world 1 gathers a copy), K1 launched 5 times
      and K4 once a forward;
    - the times and collectives of _mesh_times;
    - cli.train / cli.evaluate --mesh-devices 1 against the runs without
      a mesh, and --mesh-devices 2 refused up front;
    - two ranks over gloo on this machine's CPU: parallel/dryrun.py."""
    import torch.distributed as dist

    from fastdepth_tpu_torch import BatchLoader, Evaluator
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.parallel.distributed import init_group
    from fastdepth_tpu_torch.parallel.mesh import make_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_group("cuda", 0, 1, store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = make_mesh(1)
            print(f"mesh: {mesh.shape} on {mesh.device}, backend {dist.get_backend()}")
            if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
                fail(f"the card's mesh runs over {dist.get_backend()} on {mesh.device}")
            train_ds, val_ds = _seeded_datasets(os.path.join(tmp, "nyudepthv2"))
            rgb, depth, _ = next(iter(BatchLoader(train_ds, batch_size=BATCH, shuffle=True,
                                                  drop_last=True, pad_last=False,
                                                  num_workers=4)))
            x, d = torch.from_numpy(rgb).cuda(), torch.from_numpy(depth).cuda()
            tc = TrainConfig(lr=TRAIN_LR, weight_decay=1e-4)
            out["step_f32"] = _mesh_step_check(f"b{BATCH} f32 step", model, params, x, d, tc,
                                               mesh)
            out["step_accum2"] = _mesh_step_check(f"b{BATCH} f32 accum_steps=2 step", model,
                                                  params, x, d, tc, mesh, accum_steps=2)
            losses = {}
            for name, m in (("mesh", mesh), ("plain", None)):
                from fastdepth_tpu_torch.train import Trainer

                tr = Trainer(model, params, tc, compute_dtype=torch.bfloat16, mesh=m,
                             device=None if m is not None else "cuda")
                losses[name] = float(tr._step(tr.state, x, d, tc.lr)[1])
            rel = abs(losses["mesh"] - losses["plain"]) / abs(losses["plain"])
            print(f"mesh b{BATCH} bf16 step: loss {losses['mesh']:.6f} vs {losses['plain']:.6f} "
                  f"without the mesh (rel {rel:.2e}, bound 3e-3)")
            if not rel <= 3e-3:
                fail(f"mesh bf16 step: loss {losses} (rel {rel})")
            out["step_bf16_loss_rel_diff"] = rel

            # evaluation: the metric rows, and the kernels' launches
            loader = BatchLoader(val_ds, batch_size=BATCH, num_workers=4, pad_last=True)
            ev_m = Evaluator(model, params, batch_size=BATCH, mesh=mesh)
            ev_p = Evaluator(model, params, batch_size=BATCH, device="cuda")
            rows_m, rows_p = [], []
            _reset("K1", "K4")
            for rgb, depth, count in loader:
                rows_m.append(ev_m.fetch(ev_m(ev_m.put(rgb), ev_m.put(depth))[1], dim=1))
            torch.cuda.synchronize()
            k1, k4 = _counts("K1", "K4")
            for rgb, depth, count in loader:
                rows_p.append(ev_p(ev_p.put(rgb), ev_p.put(depth))[1].cpu().numpy())
            forwards = len(rows_m)
            # entries that differ (an inf or NaN metric equals itself here)
            apart = sum(int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum())
                        for a, b in zip(rows_m, rows_p))
            print(f"mesh eval b{BATCH} f32: {forwards} batches, {apart} metric entries apart; "
                  f"K1 {k1}, K4 {k4} launches")
            if apart:
                fail(f"Evaluator(mesh): {apart} metric entries differ from Evaluator(mesh=None)'s")
            if (k1, k4) != (STAGES_PER_FORWARD * forwards, forwards):
                fail(f"Evaluator(mesh): K1 launched {k1} and K4 {k4} times over {forwards} "
                     f"forwards, want {STAGES_PER_FORWARD} and 1 per forward")
            out["eval"] = {"batches": forwards, "rows_apart": apart, "k1_launches": k1,
                           "k4_launches": k4}
            out["times"] = _mesh_times(model, params, mesh, card)
        finally:
            dist.destroy_process_group()
        out["clis"] = _mesh_clis(model, params, tmp)

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fastdepth_tpu_torch.parallel.dryrun"],
                          capture_output=True, text=True, cwd=REPO, timeout=600)
    seconds = time.perf_counter() - t0
    report = proc.stdout[proc.stdout.find("{"):] if "{" in proc.stdout else ""
    print(f"mesh dryrun (two gloo ranks on the CPU, {seconds:.1f} s): {report}")
    if proc.returncode != 0:
        fail(f"parallel/dryrun.py failed ({proc.returncode}): {proc.stdout[-3000:]}"
             f"{proc.stderr[-3000:]}")
    out["dryrun"] = json.loads(report)
    return out


SPACE_SHARDS = (2, 4, 8)  # the space axis sizes whose K1 windows are checked at 224^2
# K1's whole-image five-level f32 b8 device time before the row window
# came (NVIDIA H100 80GB HBM3, 700 W): the unsharded call may not slow
K1_BEFORE_WINDOW_MS = 0.1734
SPACE_SERVE_FRAMES, SPACE_SERVE_PASSES = 64, 5
SPACE_ZOO = "resnet50-upproj"  # the zoo's demanding model on the space axis
SPACE_ZOO_SERVE_FRAMES, SPACE_ZOO_SERVE_PASSES = 16, 3


def _k1_level_operands(n, h, c, cout, skip, dtype, seed=0):
    """A level's operands on the card: x and skip whole, channels_last;
    the weights in K1's layout."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, cl=False):
        t = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    x = rnd(n, c, h, h, cl=True)
    w = (rnd(25, c, scale=0.2), rnd(c, scale=0.1), rnd(c, cout, scale=c ** -0.5),
         rnd(cout, scale=0.1))
    return x, w, (rnd(n, cout, 2 * h, 2 * h, cl=True) if skip else None)


def _k1_tile(x, r0, r1):
    """Image rows [r0, r1) of ``x``, zero outside the image (a rank's tile
    after the halo exchange)."""
    n, c, h, w = x.shape
    t = torch.zeros((n, c, r1 - r0, w), dtype=x.dtype, device=x.device)
    lo, hi = max(r0, 0), min(r1, h)
    t[:, :, lo - r0:hi - r0] = x[:, :, lo:hi]
    return t.contiguous(memory_format=torch.channels_last)


class _Guarded:
    """``nbytes`` of device memory mapped between two reserved, unmapped
    ranges of virtual addresses (CUDA's virtual memory management API),
    so that any access past either end faults: an operand placed at the
    head or the tail of the mapping shows a kernel that reads outside its
    rows.  ``place`` copies a channels_last tensor there."""

    class _Prop(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                    ("location", ctypes.c_int * 2), ("win32", ctypes.c_void_p),
                    ("flags", ctypes.c_ubyte * 8)]

    class _Access(ctypes.Structure):
        _fields_ = [("location", ctypes.c_int * 2), ("flags", ctypes.c_int)]

    def __init__(self, nbytes: int):
        cu = self.cu = ctypes.CDLL("libcuda.so.1")
        prop = self._Prop(1, 0, (ctypes.c_int * 2)(1, torch.cuda.current_device()))
        gran = ctypes.c_size_t()
        self._ok("cuMemGetAllocationGranularity",
                 cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0))
        self.gran = gran.value
        self.size = -(-nbytes // self.gran) * self.gran
        self.va = ctypes.c_uint64()
        self._ok("cuMemAddressReserve", cu.cuMemAddressReserve(
            ctypes.byref(self.va), ctypes.c_size_t(self.size + 2 * self.gran),
            ctypes.c_size_t(0), ctypes.c_uint64(0), ctypes.c_uint64(0)))
        self.handle = ctypes.c_uint64()
        self._ok("cuMemCreate", cu.cuMemCreate(ctypes.byref(self.handle),
                                               ctypes.c_size_t(self.size), ctypes.byref(prop),
                                               ctypes.c_uint64(0)))
        self.base = self.va.value + self.gran
        self._ok("cuMemMap", cu.cuMemMap(ctypes.c_uint64(self.base), ctypes.c_size_t(self.size),
                                         ctypes.c_size_t(0), self.handle, ctypes.c_uint64(0)))
        access = self._Access((ctypes.c_int * 2)(1, torch.cuda.current_device()), 3)
        self._ok("cuMemSetAccess", cu.cuMemSetAccess(ctypes.c_uint64(self.base),
                                                     ctypes.c_size_t(self.size),
                                                     ctypes.byref(access), ctypes.c_size_t(1)))
        base = self.base

        class _Buf:
            __cuda_array_interface__ = {"shape": (self.size,), "typestr": "|u1",
                                        "data": (base, False), "version": 2}

        self.buf = torch.as_tensor(_Buf(), device="cuda")
        if self.buf.data_ptr() != self.base:
            fail("guarded region: torch did not wrap the mapping in place")

    @staticmethod
    def _ok(name: str, rc: int) -> None:
        if rc != 0:
            fail(f"guarded region: {name} returned CUresult {rc}")

    def place(self, t: torch.Tensor, at: str) -> torch.Tensor:
        """A channels_last copy of ``t`` (N, C, H, W) whose bytes start the
        mapping (``at`` "head") or end it ("tail")."""
        n, c, h, w = t.shape
        nbytes = t.numel() * t.element_size()
        off = 0 if at == "head" else self.size - nbytes
        v = self.buf[off:off + nbytes].view(t.dtype).view(n, h, w, c).permute(0, 3, 1, 2)
        v.copy_(t)
        return v

    def close(self) -> None:
        torch.cuda.synchronize()
        self.buf = None
        cu = self.cu
        self._ok("cuMemUnmap", cu.cuMemUnmap(ctypes.c_uint64(self.base),
                                             ctypes.c_size_t(self.size)))
        self._ok("cuMemRelease", cu.cuMemRelease(self.handle))
        self._ok("cuMemAddressFree", cu.cuMemAddressFree(
            self.va, ctypes.c_size_t(self.size + 2 * self.gran)))


def _k1_guarded(guards, tile, w, sk, window) -> None:
    """K1's window call with x and the skip at the head and at the tail
    of the guarded mappings ``guards``: it must not fault, and its result
    must be bit for bit the same call's in ordinary memory.  The halo
    loads of a tile's last row block reach past the rows the window
    duplicates; this shows they stay inside the tile."""
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1

    gx, gs = guards
    with torch.inference_mode():
        want = K1.fused_decoder_stage(tile, *w, sk, window=window)
        for at in ("head", "tail"):
            got = K1.fused_decoder_stage(gx.place(tile, at), *w,
                                         None if sk is None else gs.place(sk, at),
                                         window=window)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 window {window} with its operands at the {at} of a guarded "
                     "mapping differs from the same call in ordinary memory")


def k1_window_checks(kernels: dict, card: dict) -> dict:
    """K1's row-window mode at every (tile, window) that S = 2, 4, 8 give
    at 224^2 on the pruned flagship's five levels, b8, f32 and bf16: each
    window against its plain version on the same inputs (the kernel
    bounds: f32 1e-4 * max(1, max|plain|), bf16 2^-7 * max|plain|); the
    whole-image window bit for bit the call without one; the device time
    (L2 cold) of rank 1's window at each (S, level, dtype) beside the
    whole level's and the window's bound; every window again with its
    operands at the edges of guarded mappings (_k1_guarded); K1's
    whole-image five-level f32 b8 time, both as this phase measures it
    and as the kernel phase does, within 5% of its time before the
    window (K1_BEFORE_WINDOW_MS)."""
    from fastdepth_tpu_torch.cli.bench_decoder import LEVELS
    from fastdepth_tpu_torch.engine import benchmark as B
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.parallel.spatial import k1_tiles

    levels = [lv for lv in LEVELS if lv[0].startswith("pruned")]
    out = {"windows_checked": 0, "max_err_over_tol": 0.0, "rows": []}
    # every tile and skip window fits in the largest whole map
    most = max(4 * BATCH * h * h * max(c, 4 * cout) for _, h, c, cout, _ in levels)
    guards = (_Guarded(most), _Guarded(most))
    whole_ms = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        elem = torch.finfo(dtype).bits // 8
        for level, h, c, cout, skip in levels:
            x, w, sk = _k1_level_operands(BATCH, h, c, cout, skip, dtype)
            with torch.inference_mode():
                want = K1.fused_decoder_stage(x, *w, sk)
                got = K1.fused_decoder_stage(x, *w, sk, window=(0, h, 0, 2 * h))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 {name} {level}: the whole-image window is not bit for bit the call "
                     "without one")
            act = elem * BATCH * h * h * (c + (2 if skip else 1) * 4 * cout)
            sets = [(x2, *w, s2) for x2, _, s2 in (
                _k1_level_operands(BATCH, h, c, cout, skip, dtype, seed=1 + i)
                for i in range(B.cold_copies(act)))]
            whole_ms[(name, level)] = B.time_graph(K1.fused_decoder_stage, sets) * 1e3
            for n_space in SPACE_SHARDS:
                for rank, ((r0, r1), window) in enumerate(k1_tiles(h, n_space)):
                    o0, o1 = window[2:]
                    tile = _k1_tile(x, r0, r1)
                    sk_w = (sk[:, :, o0:o1].contiguous(memory_format=torch.channels_last)
                            if skip else None)

                    def call(t, *a, window=window):
                        return K1.fused_decoder_stage(t, *a, window=window)

                    def plain(t, *a, window=window):
                        return K1.fused_decoder_stage_reference(t, *a, window=window)

                    if rank != 1:
                        with torch.inference_mode():
                            g, p = call(tile, *w, sk_w), plain(tile, *w, sk_w)
                        torch.cuda.synchronize()
                        err, tol = float((g.float() - p.float()).abs().max()), B.tolerance(p)
                        ok = err <= tol and bool(torch.isfinite(g.float()).all())
                    else:
                        bytes_w = elem * BATCH * ((r1 - r0) * h * c
                                                  + (o1 - o0) * 2 * h * cout * (2 if skip else 1))
                        cold = [(_k1_tile(s[0], r0, r1), *w,
                                 s[5][:, :, o0:o1].contiguous(memory_format=torch.channels_last)
                                 if skip else None) for s in sets[:B.cold_copies(bytes_w)]]
                        r = B.compare_and_time(call, plain, [(tile, *w, sk_w)] + cold,
                                               counter="K1")
                        err, tol, ok = r["max_abs_err"], r["tol"], r["ok"]
                        rows = (o1 + 1) // 2 - o0 // 2
                        nbytes, core, tensor = B.stage_work(
                            BATCH, rows, h, c, cout, skip, elem, tensor_cores=name == "bf16")
                        bound, by = B.bound_us(nbytes, core, tensor)
                        row = {"dtype": name, "level": level, "S": n_space, "tile_rows": r1 - r0,
                               "window": list(window), "ms": r["us"] / 1e3,
                               "plain_ms": r["plain_us"] / 1e3, "bound_ms": bound / 1e3,
                               "bound_by": by, "whole_ms": whole_ms[(name, level)],
                               "share_of_whole": r["us"] / 1e3 / whole_ms[(name, level)],
                               "max_abs_err": err, "tol": tol}
                        out["rows"].append(row)
                        print(f"K1 window {name} b{BATCH} {level} S={n_space} rank 1: tile "
                              f"{r1 - r0} rows, window {window}: max|diff| {err:.3e} (bound "
                              f"{tol:.3e}), device {row['ms']:.4f} ms = "
                              f"{row['share_of_whole']:.2f} of the whole level's "
                              f"{row['whole_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                              f"{row['bound_ms']:.4f} ms ({by})")
                    if not ok:
                        fail(f"K1 window {name} {level} S={n_space} rank {rank} {window}: "
                             f"max|diff| {err} > {tol}")
                    _k1_guarded(guards, tile, w, sk_w, window)
                    out["windows_checked"] += 1
                    out["max_err_over_tol"] = max(out["max_err_over_tol"], err / tol)
    for g in guards:
        g.close()
    out["guarded"] = {"placements": 2 * out["windows_checked"], "mapping_bytes": most,
                      "guard_bytes": guards[0].gran}
    whole = sum(v for (name, _), v in whole_ms.items() if name == "f32")
    worst = max(whole, kernels["K1"]["ms"])
    out["whole_f32_b8_ms"] = {"space_phase": whole, "kernel_phase": kernels["K1"]["ms"],
                              "before_window": K1_BEFORE_WINDOW_MS,
                              "ratio": worst / K1_BEFORE_WINDOW_MS}
    half = [r for r in out["rows"] if r["S"] == 2 and r["dtype"] == "f32"]
    out["s2_window_share_f32"] = sum(r["ms"] for r in half) / sum(
        r["whole_ms"] for r in half)
    print(f"K1 windows: {out['windows_checked']} (tile, window) shapes checked, worst "
          f"max|diff| / bound {out['max_err_over_tol']:.3f}; whole-image five levels f32 "
          f"b{BATCH}: {whole:.4f} ms here, {kernels['K1']['ms']:.4f} ms in the kernel phase, "
          f"before the window {K1_BEFORE_WINDOW_MS} ms (the slower / before = "
          f"{out['whole_f32_b8_ms']['ratio']:.3f}); {out['guarded']['placements']} guarded "
          f"placements ({most} mapped bytes between unmapped {guards[0].gran}-byte ranges) "
          f"bit for bit, none faulted; S=2 rank-1 windows over the whole levels, f32: {out['s2_window_share_f32']:.3f}; "
          f"{card['nvidia_smi']}")
    if worst > 1.05 * K1_BEFORE_WINDOW_MS:
        fail(f"K1's whole-image five levels take {whole:.4f} ms here and "
             f"{kernels['K1']['ms']:.4f} ms in the kernel phase: one is more than 5% over "
             f"their {K1_BEFORE_WINDOW_MS} ms before the window")
    return out


def _space_eval_times(model, params, meshes: dict, card: dict, label: str = "") -> dict:
    """The eval step b8 f32 (forward, metrics, the metric fetch) without a
    mesh and over each world-1 space mesh, in turns (plain, meshes,
    meshes reversed, plain), host clock ending in the fetch, median of
    MESH_TIMED after MESH_WARMUP; ``label`` names the model in the
    printed line."""
    from fastdepth_tpu_torch import Evaluator

    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.rand(BATCH, *OUTPUT_HW, 3, generator=gen, device="cuda")
    d = torch.rand(BATCH, *OUTPUT_HW, 1, generator=gen, device="cuda") * 9.5 + 0.5
    evs = {"plain": Evaluator(model, params, batch_size=BATCH, device="cuda")}
    evs.update({k: Evaluator(model, params, batch_size=BATCH, mesh=m) for k, m in meshes.items()})
    ms = {k: [] for k in evs}
    order = ["plain", *meshes, *reversed(list(meshes)), "plain"]
    for k in order:
        for _ in range(MESH_WARMUP):
            evs[k].fetch(evs[k](x, d)[1], dim=1)
        times = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            evs[k].fetch(evs[k](x, d)[1], dim=1)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[k].append(float(np.median(times)))
    row = {f"{k}_ms": v for k, v in ms.items()}
    row.update({f"{k}_over_plain": float(np.mean(ms[k]) / np.mean(ms["plain"])) for k in meshes})
    print(f"space eval step{label} b{BATCH} f32 on {card['nvidia_smi']} (host clock, ends "
          f"with the metric fetch): {json.dumps(row)}")
    return row


def _space_serve(model, params, meshes: dict, card: dict, label: str = "",
                 launches=(STAGES_PER_FORWARD, 1), n_frames: int = SPACE_SERVE_FRAMES,
                 n_passes: int = SPACE_SERVE_PASSES) -> dict:
    """A world-1 mesh InferenceServer over each mesh against the server
    without one: the same ``n_frames`` seeded frames submitted at once
    (batch 8), every answer 0 apart; frames/s of each, the median of
    ``n_passes`` passes a turn, in turns (plain, meshes, meshes reversed,
    plain), K1 and K4 ``launches`` a forward over each turn's passes (the
    flagship: 5 and 1; ``label`` names another model in the printed
    lines)."""
    from fastdepth_tpu_torch.engine.server import InferenceServer

    rng = np.random.RandomState(13)
    frames = [rng.rand(*OUTPUT_HW, 3).astype(np.float32) for _ in range(n_frames)]
    servers = {"plain": InferenceServer(model, params, batch_size=BATCH, copy_inputs=False,
                                        device="cuda")}
    servers.update({k: InferenceServer(model, params, batch_size=BATCH, copy_inputs=False,
                                       mesh=m) for k, m in meshes.items()})
    out = {}
    try:
        answers, fps = {}, {k: [] for k in servers}
        for k in ["plain", *meshes, *reversed(list(meshes)), "plain"]:
            srv = servers[k]
            srv(frames[0])  # warm-up
            b0 = srv.stats()["batches"]
            _reset("K1", "K4")
            passes = []
            for _ in range(n_passes):
                t0 = time.perf_counter()
                got = [f.result(timeout=120) for f in [srv.submit(fr) for fr in frames]]
                passes.append(len(frames) / (time.perf_counter() - t0))
                answers.setdefault(k, got)
            fps[k].append(float(np.median(passes)))
            forwards = srv.stats()["batches"] - b0
            k1, k4 = _counts("K1", "K4")
            if (k1, k4) != (launches[0] * forwards, launches[1] * forwards):
                fail(f"space server{label} {k}: K1 {k1}, K4 {k4} launches over {forwards} "
                     "forwards")
        for k in meshes:
            apart = sum(int((a != b).sum()) for a, b in zip(answers[k], answers["plain"]))
            out[k] = {"values_apart": apart, "fps": fps[k]}
            if apart:
                fail(f"space server{label} {k}: {apart} values differ from the server without a "
                     "mesh")
        out["plain"] = {"fps": fps["plain"]}
    finally:
        for srv in servers.values():
            srv.close()
    print(f"space servers{label} b{BATCH} f32, {n_frames} frames submitted at once, median "
          f"of {n_passes} passes a turn, on {card['nvidia_smi']}: {json.dumps(out)}")
    return out


def replicated_work(cfg) -> dict:
    """What the partition's replicated levels cost (parallel/spatial.py):
    the share of the forward's MACs at 224^2 (engine/roofline.layer_bounds,
    one row a conv level) that each rank of S = 2, 4, 8 computes, against
    the 1 / S of an even split.  A replicated level runs whole on every
    rank; a sharded one 1 / S of it (its halo rows are read, not
    computed)."""
    from fastdepth_tpu_torch.config import MOBILENET_STRIDES
    from fastdepth_tpu_torch.engine.roofline import layer_bounds
    from fastdepth_tpu_torch.parallel.spatial import Partition

    # each row's output rows: the stem, 13 blocks, 5 decoder levels (their
    # convs, before the upsample), the head
    rows = [OUTPUT_HW[0] // 2]
    for stride in MOBILENET_STRIDES:
        rows.append(rows[-1] // stride)
    rows += [rows[-1] << i for i in range(6)]
    macs = [r[1] for r in layer_bounds(cfg, OUTPUT_HW[0])]
    out = {}
    for n_space in SPACE_SHARDS:
        part = Partition(n_space, 0)
        rank = sum(m / (n_space if part.sharded(h) else 1) for m, h in zip(macs, rows))
        out[n_space] = {"rank_share": rank / sum(macs), "even_share": 1 / n_space,
                        "replicated_rows": sorted({h for h in rows if not part.sharded(h)})}
    print(f"space partition at {OUTPUT_HW[0]}^2: each rank's share of the forward's "
          f"{sum(macs)} MACs: {json.dumps(out)}")
    return out


def _conv_work(model, hw: int = OUTPUT_HW[0]):
    """Every conv and transposed conv of one frame of ``model``'s straight
    forward at hw^2 as (input rows, output rows, MACs), counted off
    F.conv2d and F.conv_transpose2d on the meta device (shapes only, no
    arithmetic): a conv's N Cout Ho Wo x Cin / g k^2, a transposed conv's
    N Cin Hi Wi x Cout / g k^2."""
    import torch.nn.functional as Fn

    from fastdepth_tpu_torch.models.registry import _family

    params = _family(model.config)[0](model.config, folded=True).to("meta")
    calls, conv, tconv = [], Fn.conv2d, Fn.conv_transpose2d

    def counted(op, x, w, *a, **kw):
        y = op(x, w, *a, **kw)
        calls.append((x.shape[2], y.shape[2],
                      (y.numel() if op is conv else x.numel()) * w[0].numel()))
        return y

    Fn.conv2d = lambda *a, **kw: counted(conv, *a, **kw)
    Fn.conv_transpose2d = lambda *a, **kw: counted(tconv, *a, **kw)
    try:
        with torch.no_grad():
            model.apply(params, torch.empty(1, hw, hw, 3, device="meta"))
    finally:
        Fn.conv2d, Fn.conv_transpose2d = conv, tconv
    return calls


def zoo_replicated_work(model, name: str) -> dict:
    """What the partition's replicated levels cost a zoo model: the share
    of its forward's conv MACs at 224^2 (:func:`_conv_work`) that each
    rank of S = 2, 4, 8 computes, against the 1 / S of an even split,
    under the model's own fewest rows a shard (parallel/spatial.min_rows).
    A conv whose input and output levels are both sharded runs 1 / S of
    itself on a rank; any other runs whole on every rank (from a
    replicated level it is computed whole and sliced)."""
    from fastdepth_tpu_torch.parallel.spatial import Partition, min_rows

    calls = _conv_work(model)
    total = sum(m for _, _, m in calls)
    out = {}
    for n_space in SPACE_SHARDS:
        part = Partition(n_space, 0, min_rows=min_rows(model.config))
        whole = [(ho, m) for hi, ho, m in calls if not (part.sharded(hi) and part.sharded(ho))]
        whole_macs = sum(m for _, m in whole)
        out[n_space] = {"rank_share": (whole_macs + (total - whole_macs) / n_space) / total,
                        "even_share": 1 / n_space, "min_rows": part.min_rows,
                        "whole_macs": whole_macs, "whole_rows": sorted({ho for ho, _ in whole})}
    print(f"space partition at {OUTPUT_HW[0]}^2 of {name}: each rank's share of the forward's "
          f"{total} conv MACs: {json.dumps(out)}")
    return out


def _space_zoo(meshes: dict, loader, card: dict) -> dict:
    """SPACE_ZOO at 224^2, full width, random weights (the zoo phase's),
    over the world-1 space meshes: each rank's MAC share, the Evaluator
    b8's metric rows 0 apart from no mesh with K1 and K4 launched 0 times,
    the forward b8 bit for bit the one without a mesh, the eval step's
    times in turns, and the mesh servers (answers 0 apart)."""
    from fastdepth_tpu_torch import Evaluator
    from fastdepth_tpu_torch.engine.aot import _prepare

    model, params = _zoo_model(SPACE_ZOO)
    label = f" {SPACE_ZOO}"
    out = {"replicated_work": zoo_replicated_work(model, SPACE_ZOO), "eval": {}}
    ev_p = Evaluator(model, params, batch_size=BATCH, device="cuda")
    rows_p = [ev_p(ev_p.put(r), ev_p.put(d))[1].cpu().numpy() for r, d, _ in loader]
    x = torch.from_numpy(np.random.RandomState(ZOO_SEED).rand(BATCH, *OUTPUT_HW, 3)
                         .astype(np.float32)).cuda()
    p0, f0 = _prepare(model, params, batch_size=BATCH, dtype=torch.float32, fold_bn=True,
                      impl="auto", device="cuda")
    with torch.inference_mode():
        want = f0(p0, x)
    for k, m in meshes.items():
        ev_m = Evaluator(model, params, batch_size=BATCH, mesh=m)
        _reset("K1", "K4")
        rows_m = [ev_m.fetch(ev_m(ev_m.put(r), ev_m.put(d))[1], dim=1) for r, d, _ in loader]
        torch.cuda.synchronize()
        k1, k4 = _counts("K1", "K4")
        apart = sum(int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum())
                    for a, b in zip(rows_m, rows_p))
        pm, fm = _prepare(model, params, batch_size=BATCH, dtype=torch.float32, fold_bn=True,
                          impl="auto", device=m.device, space=m.partition())
        with torch.inference_mode():
            got = fm(pm, x)
        fwd_apart = int((got != want).sum())
        print(f"space eval{label} {k} b{BATCH} f32: {len(rows_m)} batches, {apart} metric "
              f"entries apart from no mesh; forward b{BATCH}: {fwd_apart} values apart; K1 "
              f"{k1}, K4 {k4} launches")
        if apart or fwd_apart:
            fail(f"{SPACE_ZOO} over {k}: {apart} metric entries and {fwd_apart} forward values "
                 "differ from no mesh's")
        if (k1, k4) != (0, 0):
            fail(f"{SPACE_ZOO} over {k}: K1 launched {k1} and K4 {k4} times; it runs neither")
        out["eval"][k] = {"batches": len(rows_m), "rows_apart": apart,
                          "forward_values_apart": fwd_apart, "k1_launches": k1,
                          "k4_launches": k4}
    out["eval_times"] = _space_eval_times(model, params, meshes, card, label)
    out["serve"] = _space_serve(model, params, meshes, card, label, launches=(0, 0),
                                n_frames=SPACE_ZOO_SERVE_FRAMES, n_passes=SPACE_ZOO_SERVE_PASSES)
    return out


def halo_tiles_check(card: dict) -> dict:
    """The zoo's halo rules through the card's convolutions
    (``parallel/halo_check.py``): every rank's tile of the 31 sharded-op
    cases at S = 2 and 4, in this process (the exchange replaced by slices
    of the whole input), against the unsharded op on the card, f32 within
    1e-4 * max(1, max|unsharded|).  A world-1 mesh runs the unsharded ops,
    so nothing else sends a cropped tile through cuDNN here."""
    from fastdepth_tpu_torch.parallel import halo_check as H

    t0 = time.perf_counter()
    rows = H.check("cuda", torch.float32)
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r["max_abs_err"] / r["bound"])
    print(f"space halo tiles on {card['nvidia_smi']}: {len(H.OP_CASES)} cases x S = "
          f"{', '.join(map(str, H.WORLDS))}, {sum(r['sharded'] for r in rows)} of {len(rows)} "
          f"on sharded input levels; worst {worst['case']}@S={worst['world']} "
          f"{worst['max_abs_err']:.3e} (bound {worst['bound']:.1e}); "
          f"{time.perf_counter() - t0:.1f} s")
    missed = H.misses(rows)
    if missed:
        fail(f"halo rules on the card: {len(missed)} of {len(rows)} (case, S) miss the bound: "
             f"{missed}")
    return {"cases": len(H.OP_CASES), "rows": len(rows), "worst": worst}


def _space_dryrun(*extra) -> dict:
    """``parallel/dryrun.py --space`` in a subprocess (gloo ranks on the
    CPU); its JSON report, or the run fails."""
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fastdepth_tpu_torch.parallel.dryrun",
                           "--space", *extra], capture_output=True, text=True, cwd=REPO,
                          timeout=600)
    report = proc.stdout[proc.stdout.find("{"):] if "{" in proc.stdout else ""
    args = "".join(f" {a}" for a in extra)
    print(f"space dryrun{args} (gloo ranks on the CPU, {time.perf_counter() - t1:.1f} s): "
          f"{report}")
    if proc.returncode != 0:
        fail(f"parallel/dryrun.py --space{args} failed ({proc.returncode}): "
             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(report)


def space_phase(model, params, kernels: dict, card: dict) -> dict:
    """The space axis (parallel/spatial.py) and serving over a mesh on the
    one card:
    - what the replicated levels cost each rank (replicated_work);
    - K1's row-window mode (k1_window_checks);
    - the zoo's halo rules through cuDNN, every rank's tile in this
      process (halo_tiles_check);
    - world-1 make_mesh(1, 'space') and make_mesh_2d(1, 1) over NCCL:
      Evaluator metric rows 0 apart from no mesh with K1 launched 5 times
      and K4 once a forward, the eval step b8 f32 with and without the
      meshes in turns, and a mesh InferenceServer on each (answers 0 apart
      from the server without a mesh, frames/s of both);
    - the space dryrun over gloo ranks on this machine's CPU
      (``parallel/dryrun.py --space``: S = 2 forward of the trained
      flagship at 224^2 b1, atol 1e-4; the 2 x 2 Evaluator's metric rows,
      rtol 1e-5 and the deltas within 2 pixels);
    - the rest of the zoo on SPACE_ZOO (:func:`_space_zoo`) and its space
      dryrun (``--model``: S = 2 within 1e-4 of the output's scale, the
      2 x 2 Evaluator's rows within rtol 1e-5)."""
    import torch.distributed as dist

    from fastdepth_tpu_torch import BatchLoader, Evaluator
    from fastdepth_tpu_torch.parallel.distributed import init_group
    from fastdepth_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    t0 = time.perf_counter()
    out = {"replicated_work": replicated_work(model.config),
           "k1_windows": k1_window_checks(kernels, card), "halo_tiles": halo_tiles_check(card)}
    with tempfile.TemporaryDirectory() as tmp:
        init_group("cuda", 0, 1, store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            meshes = {"space1": make_mesh(1, "space"), "mesh2d_1x1": make_mesh_2d(1, 1)}
            for k, m in meshes.items():
                print(f"space mesh {k}: {m.shape} on {m.device}, backend {dist.get_backend()}")
                if dist.get_backend() != "nccl" or m.device.type != "cuda":
                    fail(f"the card's space mesh runs over {dist.get_backend()} on {m.device}")
            _, val_ds = _seeded_datasets(os.path.join(tmp, "nyudepthv2"))
            loader = BatchLoader(val_ds, batch_size=BATCH, num_workers=4, pad_last=True)
            ev_p = Evaluator(model, params, batch_size=BATCH, device="cuda")
            rows_p = [ev_p(ev_p.put(r), ev_p.put(d))[1].cpu().numpy() for r, d, _ in loader]
            out["eval"] = {}
            for k, m in meshes.items():
                ev_m = Evaluator(model, params, batch_size=BATCH, mesh=m)
                _reset("K1", "K4")
                rows_m = [ev_m.fetch(ev_m(ev_m.put(r), ev_m.put(d))[1], dim=1)
                          for r, d, _ in loader]
                torch.cuda.synchronize()
                k1, k4 = _counts("K1", "K4")
                forwards = len(rows_m)
                apart = sum(int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum())
                            for a, b in zip(rows_m, rows_p))
                print(f"space eval {k} b{BATCH} f32: {forwards} batches, {apart} metric entries "
                      f"apart from no mesh; K1 {k1}, K4 {k4} launches")
                if apart:
                    fail(f"Evaluator({k}): {apart} metric entries differ from no mesh's")
                if (k1, k4) != (STAGES_PER_FORWARD * forwards, forwards):
                    fail(f"Evaluator({k}): K1 launched {k1} and K4 {k4} times over {forwards} "
                         f"forwards, want {STAGES_PER_FORWARD} and 1 per forward")
                out["eval"][k] = {"batches": forwards, "rows_apart": apart, "k1_launches": k1,
                                  "k4_launches": k4}
            out["eval_times"] = _space_eval_times(model, params, meshes, card)
            out["serve"] = _space_serve(model, params, meshes, card)
            t1 = time.perf_counter()
            out["zoo"] = _space_zoo(meshes, loader, card)
            out["zoo"]["seconds"] = time.perf_counter() - t1
        finally:
            dist.destroy_process_group()

    out["dryrun"] = _space_dryrun()
    t1 = time.perf_counter()
    out["zoo"]["dryrun"] = _space_dryrun("--model", SPACE_ZOO)
    out["zoo"]["dryrun_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    print(f"space phase: {out['seconds']:.1f} s")
    return out


def probe_phase() -> dict:
    """The probe catalogue on the card.  The slice's path: every tag's
    kernel once, with K5's and K6's counts set to 0 just before and read
    just after.  Then each kernel against its plain version on the same
    inputs (copies, nearest x2 and taps bit for bit; f32 compute 1e-4 *
    max(1, max|plain|); bf16 2^-7 * max|plain|), with device and event
    times and the launch floor beside them, K5's copy sweep and K6's
    scale rows.  Returns per kernel (K5, K6) its launches, worst error
    and device/event times summed over its tags."""
    from fastdepth_tpu_torch.cli import probe as probe_cli
    from fastdepth_tpu_torch.engine import probes as P
    from fastdepth_tpu_torch.engine.benchmark import kernel_names, launch_floor_us

    device = torch.device("cuda")
    _reset("K5", "K6")
    for tag in P.PROBES:
        out = P.run(tag, device)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"probe {tag}: non-finite output")
    launches = dict(zip(("K5", "K6"), _counts("K5", "K6")))
    want = {k: sum(p.kernel_name == k for p in P.PROBES.values()) for k in launches}
    if launches != want:
        fail(f"probe path: launches {launches}, want one per tag {want}")
    print(f"probes: one run of every tag launched K5 {launches['K5']} and K6 "
          f"{launches['K6']} times")
    floor = launch_floor_us()
    print(f"probe launch floor: {floor:.2f} us a call (one-element zero_ in the same timer)")
    rows = probe_cli.run_probes(list(P.PROBES), device, calls=PROBE_CALLS,
                                log=lambda s: print(f"probe {s}"))
    bad = [r["tag"] for r in rows if not r["ok"]]
    if bad:
        fail(f"probes disagree with their plain versions or failed: {bad}")
    print("probe kernel/library, device time: " + ", ".join(
        f"{r['tag']} {r['device_us'] / r['library_device_us']:.2f}x" for r in rows
        if "library_device_us" in r))
    # what the one-call yardsticks of taps and up_only run as on the card
    for tag in ("taps_120", "up_only_64"):
        args = P.inputs(tag, device)
        with torch.inference_mode():
            names = kernel_names(P.PROBES[tag].library, args)
        print(f"probe {tag} library call runs: {names or 'no device activity traced'}")
    out = {}
    for k in launches:
        mine = [r for r in rows if r["kernel"] == k]
        terms = {}
        for r in mine:
            terms[r["bound_by"]] = terms.get(r["bound_by"], 0.0) + r["bound_us"]
        # one PyTorch call per tag where one computes the tag's function
        # (K5: torch.mul / torch.add on every tag; K6: torch.matmul, the
        # depthwise F.conv2d or F.interpolate on every tag but matmul_up's),
        # summed over those tags, beside the kernel's own device time over
        # the same tags
        lib_rows = [r for r in mine if "library_device_us" in r]
        lib = sum(r["library_device_us"] for r in lib_rows) / 1e3 if lib_rows else None
        out[k] = {"launches": launches[k], "max_abs_err": max(r["max_abs_err"] for r in mine),
                  "ms": sum(r["device_us"] for r in mine) / 1e3,
                  "plain_ms": sum(r["plain_device_us"] for r in mine) / 1e3,
                  "events_ms": sum(r["events_us"] for r in mine) / 1e3,
                  "plain_events_ms": sum(r["plain_events_us"] for r in mine) / 1e3,
                  "bound_ms": sum(terms.values()) / 1e3,
                  "bound_by": max(terms.items(), key=lambda kv: kv[1])[0],
                  "library_ms": lib, "library_tags": f"{len(lib_rows)} of {len(mine)}",
                  "ms_over_library_tags": sum(r["device_us"] for r in lib_rows) / 1e3,
                  "replaces": P.replaces(k), "rows": mine}
    sweep = P.copy_sweep(device, calls=PROBE_CALLS)
    print(f"copy sweep (K5, pure copy; {P.L2_NOTE}):")
    for r in sweep:
        print(f"  {r['bytes'] >> 20} MB, {r['chunk_bytes'] >> 10} KB per slot (script "
              f"chunk_rows {r['script_chunk_rows']}), prefetch {int(r['prefetch'])}: "
              f"{r['GBs']:.1f} GB/s device, {r['GBs_events']:.1f} GB/s events")
    out["sweep"] = sweep
    scale = P.compute_sweep(device, calls=PROBE_CALLS)
    print("K6 scale rows (compute_sweep, L2 cold):")
    for r in scale:
        print(f"  {probe_cli.format_scale_row(r)}")
    bad = [r["mode"] for r in scale if not r["ok"]]
    if bad:
        fail(f"K6 scale rows disagree with their plain versions: {bad}")
    out["scale"] = scale
    out["launch_floor_us"] = floor
    print("probe kernels: " + json.dumps(
        {k: {f: x for f, x in v.items() if f != "rows"} for k, v in out.items()
         if k in launches}))
    return out


def tools_phase(model, params, card: dict) -> dict:
    """engine/calibrate at a reduced call count, then cli.profile --mode
    prefix at batch 128 on the pruned flagship (f32, random weights) on
    those ceilings: 20 finite rows, and the summed bounds at most the
    measured full forward; then cli.fidelity, cli.frontier and
    cli.visualize (:func:`fidelity_check`, :func:`frontier_check`,
    :func:`visualize_check`)."""
    from fastdepth_tpu_torch.cli import profile
    from fastdepth_tpu_torch.engine import calibrate

    res = calibrate.calibrate("cuda", calls=CALIBRATE_CALLS,
                              log=lambda s: print(f"calibrate {s}"))
    c = res["ceilings"]
    print(f"calibrate: device memory {c['hbm_bps'] / 1e9:.1f} GB/s ({c['hbm_source']}), "
          f"matmul bf16 {res['matmul_tflops']['bf16']:.1f} / f32 "
          f"{res['matmul_tflops']['f32']:.1f} TFLOP/s")
    with tempfile.TemporaryDirectory() as tmp:
        ceil = os.path.join(tmp, "ceilings.json")
        with open(ceil, "w") as f:
            json.dump(res, f)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            prof = profile.main(["--mode", "prefix", "--batch", "128", "--device", "cuda",
                                 "--calls", str(PROFILE_CALLS), "--ceilings", ceil])
    for line in log.getvalue().splitlines():
        print(f"profile: {line}")
    layers = prof["layers"]
    if len(layers) != 20 or not all(np.isfinite(r["measured_us"]) for r in layers):
        fail(f"profile: {len(layers)} rows, want 20 finite ones")
    if not prof["sum_bounds_us"] <= prof["full_us"]:
        fail(f"profile: summed bounds {prof['sum_bounds_us']:.1f} us exceed the measured "
             f"full forward {prof['full_us']:.1f} us")
    print(f"tools: sum of bounds {prof['sum_bounds_us']:.1f} us <= measured full forward "
          f"{prof['full_us']:.1f} us (b128 f32, {prof['fps']:.0f} fps)")
    return {"ceilings": c, "profile_full_us": prof["full_us"],
            "profile_sum_bounds_us": prof["sum_bounds_us"],
            "fidelity": fidelity_check(model, params, card),
            "frontier": frontier_check(card), "visualize": visualize_check(model, params)}


FIDELITY_BATCHES = 8  # 64 seeded frames
FRONTIER_MODELS = (FLAGSHIP, "mobilenet-nnconv5")


def fidelity_check(model, params, card: dict) -> dict:
    """cli.fidelity's core (``compare``) on the committed trained flagship
    over seeded 480x640 frames held in memory (the card machine has no
    h5py): f32 and bf16 metric rows and their deltas, finite."""
    from fastdepth_tpu_torch import OUTPUT_SIZE, RAW_SIZE, ValPipeline
    from fastdepth_tpu_torch.cli import fidelity

    batches = _frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE), seed=13,
                      n_batches=FIDELITY_BATCHES)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, table = fidelity.compare(model, params, lambda: _Frames(batches), batch_size=BATCH,
                                    device="cuda")
    for line in log.getvalue().splitlines():
        print(f"fidelity: {line}")
    if not all(np.isfinite([v for row in table.values() for v in row.values()])):
        fail(f"fidelity: non-finite table {table}")
    print(f"fidelity on {card['nvidia_smi']} ({FIDELITY_BATCHES * BATCH} synthetic frames, "
          f"b{BATCH}): {json.dumps(table)}")
    return table


def frontier_check(card: dict) -> dict:
    """cli.frontier at a reduced sweep (the flagship and mobilenet-nnconv5,
    b1 and b32, both dtypes) under its --budget-s: every (model, dtype,
    batch) has its 'xla' and 'opt' rows, and the flagship its 'mixed' row
    from the committed tuning/h100.* record."""
    from fastdepth_tpu_torch.cli import frontier

    if not os.path.exists(frontier.tuning_path(FLAGSHIP)):
        fail(f"frontier: no committed record {frontier.tuning_path(FLAGSHIP)}")
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rows = frontier.main(["--models", ",".join(FRONTIER_MODELS), "--batches", "1,32",
                                  "--calls", "10", "--budget-s", "120",
                                  "--out", os.path.join(tmp, "frontier")])
        with open(os.path.join(tmp, "frontier.md")) as f:
            md = f.read()
    for line in log.getvalue().splitlines():
        print(f"frontier: {line}")
    have = {(r["model"], r["dtype"], r["batch"], r["impl"]) for r in rows}
    want = {(m, d, b, i) for m in FRONTIER_MODELS for d in ("bfloat16", "float32")
            for b in (1, 32) for i in ("xla", "opt", "mixed") if i != "mixed" or m == FLAGSHIP}
    if have != want or "| model | dtype | batch | impl |" not in md:
        fail(f"frontier: rows {sorted(have)}, want {sorted(want)}")
    print(f"frontier on {card['nvidia_smi']}: {json.dumps(rows)}")
    return {"rows": rows}


def visualize_check(model, params) -> dict:
    """cli.visualize on a seeded rgb, depth and the flagship's prediction:
    three PNGs of the input's size."""
    from PIL import Image

    from fastdepth_tpu_torch.cli import visualize
    from fastdepth_tpu_torch.engine.aot import compile_forward

    rng = np.random.RandomState(14)
    rgb = rng.rand(*OUTPUT_HW, 3).astype(np.float32)
    fn, p = compile_forward(model, params, batch_size=1, image_size=OUTPUT_HW, device="cuda")
    pred = fn(p, torch.from_numpy(rgb[None]).cuda()).permute(0, 3, 1, 2).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        args = []
        for name, arr in (("rgb", rgb), ("depth", rng.uniform(0.5, 10, OUTPUT_HW)),
                          ("pred", pred)):
            np.save(os.path.join(tmp, f"{name}.npy"), arr)
            args += [f"--{name}", os.path.join(tmp, f"{name}.npy")]
        with contextlib.redirect_stdout(io.StringIO()):
            visualize.main(args + ["--out-dir", tmp])
        sizes = {}
        for name in ("rgb", "depth", "pred"):
            with Image.open(os.path.join(tmp, f"{name}.png")) as im:
                sizes[name] = [im.size[1], im.size[0], len(im.getbands())]
    if any(v != [*OUTPUT_HW, 3] for v in sizes.values()):
        fail(f"visualize: PNG shapes {sizes}")
    print(f"visualize: rgb, depth, pred PNGs written, each {OUTPUT_HW[0]}x{OUTPUT_HW[1]}x3")
    return sizes


def graft_phase(card: dict) -> dict:
    """``fastdepth_tpu_torch/graft_entry.py``, the counterpart of the root
    __graft_entry__.py: ``entry()``'s forward on the card against the CPU
    forward of the same params, on its zeros and on seeded frames, within
    1e-3 * max(1, max|cpu|) (f32, TF32 off); ``dryrun_multichip(1)`` on the
    card (NCCL, world 1); ``dryrun_multichip(4, device='cpu')`` over four
    gloo ranks on this machine's CPU (its 1 x 4 (data, space) mesh too), in
    a fresh process."""
    import copy

    from fastdepth_tpu_torch import graft_entry as G

    out = {}
    fwd, (params, zeros) = G.entry()
    x = torch.from_numpy(np.random.RandomState(15).rand(*zeros.shape).astype(np.float32))
    params_cpu = copy.deepcopy(params).cpu()
    for name, rgb in (("zeros", zeros.cpu()), ("seeded", x)):
        got = fwd(params, rgb.cuda()).cpu()
        want = fwd(params_cpu, rgb)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        bound = 1e-3 * max(1.0, scale)
        print(f"graft entry() {name} b{zeros.shape[0]} f32 on {card['nvidia_smi']}: "
              f"{tuple(got.shape)} {got.dtype}, max|card - cpu| {err:.3e} (bound {bound:.1e}, "
              f"max|cpu| {scale:.4f})")
        if tuple(got.shape) != (zeros.shape[0], *OUTPUT_HW, 1) or not err <= bound:
            fail(f"entry() {name}: {tuple(got.shape)}, max|card - cpu| {err} > {bound}")
        out[f"entry_{name}"] = {"max_abs_err": err, "bound": bound, "max_cpu": scale}
    t0 = time.perf_counter()
    out["dryrun_1"] = G.dryrun_multichip(1)
    print(f"graft dryrun_multichip(1) (NCCL, world 1): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fastdepth_tpu_torch.graft_entry", "multichip",
                           "4", "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
                          timeout=600)
    ok = [s for s in proc.stdout.splitlines() if s.startswith("dryrun_multichip(4) ok:")]
    print(f"graft dryrun_multichip(4, device='cpu') (four gloo ranks on the CPU, "
          f"{time.perf_counter() - t0:.1f} s): {ok[0] if ok else proc.stdout[-500:]}")
    if proc.returncode != 0 or len(ok) != 1 or "1x4 (data, space) mesh too" not in ok[0]:
        fail(f"graft_entry multichip 4 --device cpu exited {proc.returncode}: "
             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    out["dryrun_4_cpu"] = ok[0]
    return out


# --- the measurement modules of scripts/ (fastdepth_tpu_torch/scripts/) -----

# each module's JSON keys: its script's, and the port's additions ('card';
# 'launches' where the module runs K1 and K4)
SCRIPT_KEYS = {
    "soak_serving": {"batch", "impl", "dtype", "minutes", "chunk", "windows_fps", "mean_fps",
                     "min_fps", "max_fps", "frames_total", "card", "launches"},
    "soak_server_r4": {"what", "minutes", "frames", "windows_fps", "mean_fps", "spread_pct",
                       "occupancy", "client_depth", "latency_ms", "note", "card", "launches"},
    "bench_serve_daemon": {"float32_engine_fps", "float32_socket_fps", "uint8_engine_fps",
                           "uint8_socket_fps", "clients", "frames_per_client", "batch", "dtype",
                           "card", "launches"},
    "bench_chain_serving": {"frames_per_case", "hw", "dtype", "cases", "device_b1_compute_us",
                            "card", "launches"},
    "bench_chain_depth_frontier": {"surface", "k", "hw", "dtype", "rows", "knee",
                                   "window_padding", "card", "launches"},
    "soak_server_socket_r5": {"surface", "backend", "minutes", "clients", "depth_per_client",
                              "batch", "dtype", "frames_total", "mean_fps", "window_fps",
                              "window_spread_pct", "windows", "engine_ceiling_fps",
                              "fraction_of_engine_ceiling", "host_cores", "note", "card",
                              "launches"},
    "bench_host_pipeline": {"native_built", "host_cores", "items", "loader", "per_item_ms",
                            "items_per_s_per_core", "device_augment", "feed_projection",
                            "reader", "card"},
    "train_rehearsal": {"what", "result", "epochs", "train_items", "trained_rmse_m",
                        "trained_delta1", "train_time_best_row_bf16", "weights", "log", "rerun",
                        "val16_cpu_row", "card"},
    "analyze_spatial_halo": {"what", "t1_b1_us", "t1_source", "note", "rows", "card"},
    "confirm_b1_opt": {"reps", "calls", "rows", "launches", "card"},
    "probe_r5_device_gathers": {"batch", "calls", "rows", "card"},
    "probe_r5_lut_alternatives": {"batch", "calls", "lookups_per_call", "rows", "errors", "card"},
    "bench_train_device_aug_r5": {"batch", "calls", "dtype", "rows", "aug_cost_pct_dot",
                                  "aug_cost_pct_gather", "repeats", "runs",
                                  "aug_cost_pct_runs", "card"},
}
# the rows of the device-augment modules: their scripts' and the port's
# gather forms beside the dot forms
SCRIPT_ROWS = {
    "probe_r5_device_gathers": {"rgb_u8_gather", "rgb_u32_gather", "depth_f32_gather",
                                "jitter_slot_2d", "jitter_slot_2d_gather", "small_lut_256",
                                "unit_lut_take", "pil_l_compute", "full_augment",
                                "full_augment_gather"},
    "probe_r5_lut_alternatives": {"take_256", "onehot_dot", "select_sum", "select_sum_bt",
                                  "onehot_dot_bt", "sat_two_dots", "block_gather_16"},
    "bench_train_device_aug_r5": {"plain_train_fps", "device_augment_dot_train_fps",
                                  "device_augment_gather_train_fps"},
}
AUG_PROBE_BATCH, AUG_PROBE_CALLS = 8, 3  # the device-augment probes in scripts_phase
AUG_TRAIN_BATCH, AUG_TRAIN_CALLS, AUG_TRAIN_REPEATS = 32, 5, 2  # and the train bench
TRAIN_ROW_KEYS = {"batch", "remat", "dtype", "step_ms", "train_fps", "final_loss", "card"}
FUSED_B1_ROWS = ("fp32 b1 fused", "bf16 b1 fused", "bf16 b1 AOT(fused)", "bf16 b1 bundle(fused)")


def _per_forward(label: str, launches: dict) -> None:
    """K1 five times and K4 once a forward, over a positive number of
    forwards (``_serve_one``'s rule); a replay of compile_forward's graph
    is a forward whose launches its wrappers do not count."""
    n, replays = launches["forwards"], launches["replays"]
    if not (n > 0 and (launches["K1"] + STAGES_PER_FORWARD * replays,
                       launches["K4"] + replays) == (STAGES_PER_FORWARD * n, n)):
        fail(f"scripts {label}: K1 launched {launches['K1']} and K4 {launches['K4']} times "
             f"with {replays} graph replays over {n} forwards, want {STAGES_PER_FORWARD} and "
             "1 a forward")


def _served_frame_check(label: str, answers, card: dict) -> float:
    """The modules' first answers to their seeded frame (bf16, uint8 in, f16
    out) against the port's bf16 fused forward called directly on the same
    frame and weights: serve_phase's bf16 bound, 2^-7 max|ref|, plus one
    f16 rounding, 2^-10 max|ref|."""
    from fastdepth_tpu_torch.engine.aot import _prepare, normalize
    from fastdepth_tpu_torch.scripts import _serving as S

    model, params = S.flagship()
    p, apply = _prepare(model, params, batch_size=1, dtype=torch.bfloat16, fold_bn=True,
                        impl="fused", device="cuda")
    frame = torch.from_numpy(S.seeded_frame())[None].cuda()
    with torch.inference_mode():
        ref = apply(p, normalize(frame, torch.bfloat16)).float().cpu().numpy()[0]
    scale = float(np.abs(ref).max())
    bound = (2 ** -7 + 2 ** -10) * scale
    worst = 0.0
    for name, got in answers:
        if got.shape != ref.shape or got.dtype != np.float16:
            fail(f"scripts {label} {name}: answer {got.shape} {got.dtype}, want {ref.shape} "
                 "float16")
        err = float(np.abs(got.astype(np.float32) - ref).max())
        worst = max(worst, err)
        print(f"scripts {label} {name} on {card['nvidia_smi']}: first served answer vs the bf16 "
              f"fused forward max|diff| {err:.3e} (bound {bound:.3e}, max|ref| {scale:.4f})")
        if not err <= bound:
            fail(f"scripts {label} {name}: served answer off by {err} > {bound}")
    return worst


def scripts_phase(card: dict) -> dict:
    """Every module of fastdepth_tpu_torch/scripts/ through its ``main`` on
    the card at reduced length, its JSON checked for its script's keys
    (:data:`SCRIPT_KEYS`): the soaks 0.25 min with one window each (the
    forward with --impl fused, the in-process server, the socket daemon on
    the flagship and on the null model), the K-client daemon, the chain
    cases at 512 frames, the depth frontier at depths 1, 8, 32, the train
    sweep b8 / b32 x remat 0 / 1 x f32 / bf16 at 5 steps, the host sweep
    over 64 items, the rehearsal of 2 epochs over 64 items, the roofline
    from a b128 bf16 profile, the frontier PNG, the halo analysis, the b1
    ordering, and the device-augment modules (the two probes at b8, 3
    calls, no row out of memory; the train bench at b32, 5 steps, 2
    rounds; rows :data:`SCRIPT_ROWS`).  K1 five times and K4 once a forward on the
    serving modules and the fused b1 rows; the soak server's and the chain
    servers' first answers held against the bf16 fused forward
    (:func:`_served_frame_check`)."""
    from fastdepth_tpu_torch.scripts import (
        analyze_spatial_halo, bench_chain_depth_frontier, bench_chain_serving,
        bench_host_pipeline, bench_serve_daemon, bench_train, bench_train_device_aug_r5,
        confirm_b1_opt, make_frontier_plot, make_roofline, probe_r5_device_gathers,
        probe_r5_lut_alternatives, soak_server_r4, soak_server_socket_r5, soak_serving,
        train_rehearsal)

    smi = card["nvidia_smi"]
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(mod, argv, key=None, **kw):
            name = mod.__name__.rsplit(".", 1)[-1]
            key = key or name
            path = os.path.join(tmp, f"{key}.json")
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as log:
                res = mod.main([*argv, "--out", path], **kw)
            seconds[key] = round(time.perf_counter() - t, 1)
            for line in log.getvalue().splitlines()[-6:]:
                print(f"scripts {key}: {line}")
            with open(path) as f:
                written = json.load(f)
            if written != json.loads(json.dumps(res)):
                fail(f"scripts {key}: the JSON written differs from main's result")
            want = SCRIPT_KEYS.get(name)
            if want is not None and set(written) != want:
                fail(f"scripts {key}: keys {sorted(set(written) ^ want)} differ from its "
                     "script's")
            out[key] = res
            return res

        res = run(soak_serving, ["0.25", "--window-s", "15", "--impl", "fused"])
        _per_forward("soak_serving", res["launches"])
        print(f"scripts soak_serving fused b128 bf16 on {smi}: {res['mean_fps']} frames/s "
              f"over {len(res['windows_fps'])} window(s)")
        answers = []
        res = run(soak_server_r4, ["0.25", "--window-s", "15"], answers=answers)
        _per_forward("soak_server_r4", res["launches"])
        print(f"scripts soak_server_r4 b128 bf16 uint8/f16 on {smi}: {res['mean_fps']} "
              f"frames/s, p50 {res['latency_ms']['p50']} ms, p99 {res['latency_ms']['p99']} "
              f"ms, occupancy {res['occupancy']}")
        served = [("soak_server_r4", answers[0])]
        res = run(bench_serve_daemon, ["--frames-per-client", "64"])
        _per_forward("bench_serve_daemon", res["launches"])
        print(f"scripts bench_serve_daemon 8 clients b32 bf16 on {smi}: f32 engine "
              f"{res['float32_engine_fps']} / socket {res['float32_socket_fps']}, uint8 "
              f"engine {res['uint8_engine_fps']} / socket {res['uint8_socket_fps']} frames/s")
        answers = []
        res = run(bench_chain_serving, ["--frames", "512"], answers=answers)
        _per_forward("bench_chain_serving", res["launches"])
        print(f"scripts bench_chain_serving on {smi}: " + ", ".join(
            f"{c['case']} {c['fps']} frames/s" for c in res["cases"])
            + f"; device b1 compute {res['device_b1_compute_us']} us")
        served += answers
        res = run(bench_chain_depth_frontier, ["--depths", "1,8,32", "--max-frames", "512"])
        _per_forward("bench_chain_depth_frontier", res["launches"])
        print(f"scripts bench_chain_depth_frontier K=32 on {smi}: " + ", ".join(
            f"depth {r['depth']} {r['fps']} frames/s p50 {r['latency_ms']['p50']} ms"
            for r in res["rows"]) + f"; knee {res['knee']['depth']}")
        for backend, minutes in (("cuda", "0.25"), ("null", "0.1")):
            res = run(soak_server_socket_r5, [minutes, "--window-s", "15", "--backend", backend,
                                              "--socket", os.path.join(tmp, f"{backend}.sock")],
                      key=f"soak_server_socket_r5_{backend}")
            if backend == "cuda":
                _per_forward("soak_server_socket_r5", res["launches"])
            elif (res["launches"]["K1"], res["launches"]["K4"]) != (0, 0):
                fail(f"scripts socket soak null: K1/K4 launched {res['launches']}")
            print(f"scripts soak_server_socket_r5 {backend} 4 clients x 256 b128 on {smi}: "
                  f"{res['mean_fps']} frames/s over the socket, engine ceiling "
                  f"{res['engine_ceiling_fps']} in process ({res['fraction_of_engine_ceiling']})")
        out["served_max_abs_err"] = _served_frame_check("served", served, card)
        rows = run(bench_train, ["--batches", "8,32", "--remat", "0,1", "--dtypes", "fp32,bf16",
                                 "--steps", "5"])
        if len(rows) != 8 or any(set(r) != TRAIN_ROW_KEYS or not np.isfinite(r["final_loss"])
                                 for r in rows):
            fail(f"scripts bench_train: rows {rows}")
        print(f"scripts bench_train on {smi}: " + ", ".join(
            f"b{r['batch']} remat={int(r['remat'])} {r['dtype']} {r['step_ms']} ms"
            for r in rows))
        res = run(bench_host_pipeline, ["--items", "64", "--workers", "2", "--modes",
                                        "thread,process", "--batch-size", "8", "--calls", "16"])
        print(f"scripts bench_host_pipeline on {smi} host ({res['host_cores']} cores): one "
              f"core {res['items_per_s_per_core']} items/s; best "
              f"{res['feed_projection']['best_measured']['items_per_s']} items/s; device train "
              f"{res['feed_projection']['device_train_fps']} frames/s")
        res = run(train_rehearsal, ["--epochs", "2", "--train-items", "64", "--val-items", "16",
                                    "--weights-out", os.path.join(tmp, "w.npz"), "--log",
                                    os.path.join(tmp, "r.log")])
        print(f"scripts train_rehearsal on {smi}: {res['result']}, f32 b1 RMSE "
              f"{res['trained_rmse_m']} m, delta1 {res['trained_delta1']}")
        t = time.perf_counter()
        md = os.path.join(tmp, "roofline.md")
        with contextlib.redirect_stdout(io.StringIO()):
            lines = make_roofline.main(["--bf16", "--calls", "5", "--out", md])
        seconds["make_roofline"] = round(time.perf_counter() - t, 1)
        if sum(ln.startswith("| enc") or ln.startswith("| dec") for ln in lines) != 20:
            fail("scripts make_roofline: not 20 rows")
        print(f"scripts make_roofline b128 bf16 on {smi}: {lines[-1]}")
        png = make_frontier_plot.main(["--out", os.path.join(tmp, "frontier.png")])
        if os.path.getsize(png) < 1000:
            fail("scripts make_frontier_plot: no image")
        res = run(analyze_spatial_halo, [])
        print(f"scripts analyze_spatial_halo on {smi}: t1 {res['t1_b1_us']} us; " + ", ".join(
            f"S={r['space_shards']} {r['halo_bytes_per_device']} B -> "
            f"{r['breakeven_ici_GBs']} GB/s" for r in res["rows"]))
        res = run(confirm_b1_opt, ["--reps", "1", "--calls", "50"])
        for name in FUSED_B1_ROWS:
            _per_forward(f"confirm_b1_opt {name}", res["launches"][name])
        print(f"scripts confirm_b1_opt on {smi}: " + ", ".join(
            f"{r['name']} {r['us_med']} us" for r in res["rows"]))
        for mod, b, argv in (
                (probe_r5_device_gathers, AUG_PROBE_BATCH, ["--calls", str(AUG_PROBE_CALLS)]),
                (probe_r5_lut_alternatives, AUG_PROBE_BATCH, ["--calls", str(AUG_PROBE_CALLS)]),
                (bench_train_device_aug_r5, AUG_TRAIN_BATCH,
                 ["--calls", str(AUG_TRAIN_CALLS), "--repeats", str(AUG_TRAIN_REPEATS)])):
            name = mod.__name__.rsplit(".", 1)[-1]
            res = run(mod, ["--batch", str(b)] + argv)
            rows = res["rows"]
            if (set(rows) != SCRIPT_ROWS[name] or res.get("errors")
                    or not all(np.isfinite(v) and v > 0 for v in rows.values())):
                fail(f"scripts {name}: rows {rows}, errors {res.get('errors')}")
            print(f"scripts {name} b{b} on {smi}: " + ", ".join(
                f"{k} {v}" for k, v in rows.items()))
    print(f"scripts: seconds by module {json.dumps(seconds)}")
    return out


KERNELS = [
    # (key, name, source, replaces); K5's and K6's replaces come from the
    # probe catalogue
    ("K1", "fused_decoder_stage", "fastdepth_tpu_torch/csrc/fused_decoder.cu",
     "fastdepth_tpu/ops/pallas/fused_decoder.py:50"),
    ("K2", "fused_decoder_stage_hwbc", "fastdepth_tpu_torch/csrc/fused_decoder_hwbc.cu",
     "fastdepth_tpu/ops/pallas/fused_decoder.py:152"),
    ("K3", "fused_decoder_stage_v3", "fastdepth_tpu_torch/csrc/fused_decoder_v3.cu",
     "fastdepth_tpu/ops/pallas/fused_decoder.py:249"),
    ("K4", "fused_pointwise_head", "fastdepth_tpu_torch/csrc/pointwise_head.cu",
     "fastdepth_tpu/ops/pallas/fused_decoder.py:379"),
    ("K5", "staged_copy", "fastdepth_tpu_torch/csrc/probe_copy.cu", None),
    ("K6", "staged_compute", "fastdepth_tpu_torch/csrc/probe_stage.cu", None),
    ("K7", "conv_epilogue", "fastdepth_tpu_torch/csrc/conv_epilogue.cu", None),
    ("K8", "metric_sums", "fastdepth_tpu_torch/csrc/metric_sums.cu", None),
]


def main() -> None:
    t0 = time.perf_counter()
    phase_s = {}

    def timed(fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        phase_s[fn.__name__] = round(time.perf_counter() - t, 1)
        return result

    card = timed(device_phase)
    timed(build_phase)
    kernels = timed(kernel_phase)
    model, params = timed(load_weights)
    e2e = timed(e2e_phase, model, params)
    fwd = timed(forwards_phase, model, params)
    dep = timed(deploy_phase, model, params)
    srv = timed(serve_phase, model, params, card)
    tuned = timed(tuned_phase, model, params, card)
    bundle = timed(bundle_phase, model, params, card)
    timed(zoo_phase, card)
    timed(train_phase, model, params)
    timed(input_phase, model, params, card)
    timed(mesh_phase, model, params, card)
    timed(space_phase, model, params, kernels, card)
    kernels.update(timed(probe_phase))
    timed(tools_phase, model, params, card)
    timed(graft_phase, card)
    scripts = timed(scripts_phase, card)
    print(f"scripts_phase: {phase_s['scripts_phase']} s on {card['nvidia_smi']}")
    # launches: each kernel's count on the f32 run of its path (K1: the
    # eval path, K2/K3: the v2/v3 forwards, K4: the deploy path, K5/K6:
    # the probe catalogue's run; K7 and K8: the eval path's f32 run, as
    # K1, their counts zeroed just before the run); ms /
    # plain_ms: device time (events_ms beside it), f32, batch 8, summed
    # over the pruned flagship's five levels (K4: its head; K5/K6: over
    # their probe tags; K7: bf16 b128, its 27 encoder epilogues; K8: b128
    # at 224x224), with the worst
    # f32 error over the checked shapes (K8: its float sums' largest gap
    # from the plain version's, absolute and max_rel_err relative, as
    # measured at METRIC_SHAPES); bound_ms the least time for the
    # same calls' work at the H100's published rates (summed likewise),
    # bound_by the term that binds most of it; library_ms one PyTorch call
    # per call where one computes the same function, else null (K5 and K6:
    # summed over library_tags, beside ms_over_library_tags, the kernel's
    # own time over the same tags); serve_launches: K1's, K4's and K7's counts
    # over the f32 server's counted run (serve phase); mixed_launches: over
    # the hand-mixed map's f32 validate() (tuned phase: 3 'pallas' levels);
    # bundle_launches: over the f32 bundle's cli.deploy --load-bundle run in
    # a fresh process (bundle phase: BUNDLE_LOAD_CALLS calls);
    # scripts_launches: over the soak server's run (scripts phase)
    launches = {"K1": e2e["f32"]["launches"], "K2": fwd["f32"]["v2"]["launches"],
                "K3": fwd["f32"]["v3"]["launches"], "K4": dep["f32"]["k4_launches"],
                "K5": kernels["K5"]["launches"], "K6": kernels["K6"]["launches"],
                "K7": e2e["f32"]["k7_launches"], "K8": e2e["f32"]["k8_launches"]}
    serve_launches = {"K1": srv["f32"]["launches"], "K4": srv["f32"]["k4_launches"],
                      "K7": srv["f32"]["k7_launches"]}
    mixed_launches = {"K1": tuned["mixed hand f32"]["launches"],
                      "K4": tuned["mixed hand f32"]["k4_launches"],
                      "K7": tuned["mixed hand f32"]["k7_launches"]}
    bundle_launches = dict(zip(("K1", "K4", "K7"), bundle["f32"]["launches"]))
    scripts_launches = {k: scripts["soak_server_r4"]["launches"][k] for k in ("K1", "K4")}
    print(f"chip_smoke: seconds by phase {json.dumps(phase_s)}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces or kernels[key]["replaces"], "launches": launches[key],
        "max_abs_err": kernels[key]["max_abs_err"], "ms": kernels[key]["ms"],
        "plain_ms": kernels[key]["plain_ms"], "bound_ms": kernels[key]["bound_ms"],
        "bound_by": kernels[key]["bound_by"], "library_ms": kernels[key]["library_ms"],
        "events_ms": kernels[key]["events_ms"],
        "plain_events_ms": kernels[key]["plain_events_ms"],
        **{f: kernels[key][f] for f in ("max_rel_err", "library_tags", "ms_over_library_tags")
           if f in kernels[key]},
        **({"serve_launches": serve_launches[key]} if key in serve_launches else {}),
        **({"mixed_launches": mixed_launches[key]} if key in mixed_launches else {}),
        **({"bundle_launches": bundle_launches[key]} if key in bundle_launches else {}),
        **({"scripts_launches": scripts_launches[key]} if key in scripts_launches else {}),
    } for key, name, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
