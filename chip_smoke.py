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
   at the H100's published rates);
4. eval path: the committed trained weights (docs/rehearsal_model_r5.npz)
   -> build -> fold -> Evaluator(impl='auto') -> validate() over seeded
   raw 480x640 frames put through the shared val pipeline, at f32 and
   bf16; counts K1's and K4's launches on that run, and holds the fused
   forward against the port's straight (plain PyTorch) forward;
5. v2 / v3 forwards: the same weights through K2 or K3 and K4 at batch
   8, held against the straight forward, with their launch counts;
6. deploy path: cli.deploy.main on a seeded 224x224 rgb npy, f32 and
   --bf16, with randomized-input timing; its saved prediction against the
   straight forward, and K1's and K4's launches on every call; then the
   deploy CLI in f32 in a fresh process, whose TF32 flags start at
   PyTorch's defaults: it must turn TF32 off and its prediction must
   agree with the straight forward (TF32 off) within 1e-3;
7. probes: every tag of the probe catalogue (engine/probes.py, the
   scripts' Pallas probes) runs its kernel (K5, K6, or K3) once, with
   K5's and K6's launches counted on that run; then the launch floor
   (the least a call costs in the same timer), each kernel against its
   plain version with both times, its bound and, where one PyTorch call
   computes the same function, that call's time and the kernel's ratio
   to it (with the CUDA kernels K6's taps and up_only yardsticks run
   as); K5's copy sweep (dma_copy) and K6's scale rows (compute_sweep),
   each checked against its plain version;
8. tools: engine/calibrate (reduced call count) measures the card's
   ceilings, and cli.profile --mode prefix --batch 128 profiles the
   pruned flagship on them; the summed roofline bounds must not exceed
   the measured full forward;
9. prints the kernels' JSON line, then the result line.

Nothing here, and nothing of the port it drives, imports JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
E2E_BATCHES = 4
STAGES_PER_FORWARD = 5

DEPLOY_WARMUP, DEPLOY_RUN = 10, 50
PROBE_CALLS = 10
CALIBRATE_CALLS = 3
PROFILE_CALLS = 5
OUTPUT_HW = (224, 224)

# (H=W, C) of the 1x1 head K4 runs: the pruned flagship's, then the unpruned
HEADS = [("pruned", 224, 16), ("unpruned", 224, 32)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase() -> None:
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
    level, at the eval path's batch; K1 also at the deploy path's batch
    1, whose launch geometry differs; K4 at the heads.  Each is held
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
        ("K1", K1, K1.fused_decoder_stage, {}, (BATCH, DEPLOY_BATCH)),
        ("K2", K2, K2.fused_decoder_stage_hwbc, F.V2_BLOCK_BATCHES, (BATCH,)),
        ("K3", K3, K3.fused_decoder_stage_v3, F.V3_BLOCK_BATCHES, (BATCH,)),
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
        for label, mod, fn, bbs, batches in stage_kernels:
            for level, h, c, cout, skip in LEVELS:
                which, index = level[:-1], int(level[-1])
                kwargs = {"block_batch": bbs[index]} if bbs else {}
                for n in batches:
                    print(f"{label} {name} b{n} {level} launch: "
                          + format_geometry(geometry(label, n, h, c, cout, name,
                                                     kwargs.get("block_batch"))))
                    r = level_row(level, n, h, c, cout, skip, name, kernel=(mod, fn), **kwargs)
                    record(label, r, which == "pruned" and n == BATCH, dtype=name, batch=n,
                           model=which, H=h, C=c, Cout=cout, skip=skip, **kwargs)
        for which, h, c in HEADS:
            elem = torch.finfo(dtype).bits // 8
            px = BATCH * h * h
            sets = _head_sets(BATCH, h, c, dtype, cold_copies(elem * px * (c + 1)))
            r = compare_and_time(K4.pointwise_head, K4.pointwise_head_reference, sets,
                                 counter=K4)
            r["bound_us"], r["bound_by"] = bound_us(elem * (px * (c + 1) + c + 1),
                                                    2 * px * c + 2 * px)
            record("K4", r, which == "pruned", dtype=name, batch=BATCH, model=which, H=h, C=c)
    for label, row in out.items():
        row["bound_by"] = max(row.pop("bound_terms").items(), key=lambda kv: kv[1])[0]
        print(f"{label} f32 b{BATCH} sum over the pruned flagship's "
              f"{'head' if label == 'K4' else 'five levels'}: device {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); events {row['events_ms']:.4f} ms, plain "
              f"{row['plain_events_ms']:.4f} ms")
    return out


class _Frames:
    """A loader over host batches already in memory: (rgb, depth, count)."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = range(sum(b[2] for b in batches))

    def __iter__(self):
        return iter(self.batches)


def _frames(pipe, seed: int):
    """Seeded raw 480x640 uint8 RGB + f32 depth frames (the NYU h5 item
    format), put through the shared val pipeline (resize/crop to
    224x224) and /255, as NYUDataset's host path does."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(E2E_BATCHES):
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


def _counts(*mods):
    return tuple(m.LAUNCHES for m in mods)


def _reset(*mods):
    for m in mods:
        m.LAUNCHES = 0


def e2e_phase(model, params) -> dict:
    from fastdepth_tpu_torch import OUTPUT_SIZE, RAW_SIZE, Evaluator, ValPipeline, validate
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import head as K4

    loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                             seed=0))
    rgb0, depth0, _ = loader.batches[0]
    forwards = E2E_BATCHES + 1  # validate() warms up on the first batch
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ev = Evaluator(model, params, batch_size=BATCH, dtype=dtype, impl="auto",
                       device="cuda")
        _reset(K1, K4)
        avg = validate(loader, ev, print_freq=0, make_images=False,
                       log=lambda s: print(s.strip().replace("\n", " ")))
        torch.cuda.synchronize()
        k1, k4 = _counts(K1, K4)
        if (k1, k4) != (STAGES_PER_FORWARD * forwards, forwards):
            fail(f"{name}: K1 launched {k1} and K4 {k4} times over {forwards} forwards, "
                 f"want {STAGES_PER_FORWARD} and 1 per forward")
        x, d = ev.put(rgb0), ev.put(depth0)
        pred, _ = ev(x, d)
        torch.cuda.synchronize()
        if tuple(pred.shape) != (BATCH, *OUTPUT_SIZE, 1) or not torch.isfinite(pred).all():
            fail(f"{name}: predictions of shape {tuple(pred.shape)}, finite: "
                 f"{bool(torch.isfinite(pred).all())}")
        fps = BATCH / _median_ms(ev, (x, d)) * 1e3
        row = {k: getattr(avg, k) for k in ("rmse", "mae", "delta1", "absrel", "lg10")}
        out[name] = {"launches": k1, "k4_launches": k4, "forwards": forwards, "metrics": row,
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


def forwards_phase(model, params) -> dict:
    """apply_fastdepth_fused_v2 / _v3 at batch 8 on the trained weights:
    5 launches of K2 or K3 and 1 of K4 per forward; f32 within 1e-3 of the
    straight forward (TF32 off), bf16 finite.  Also times each forward
    (and the K1 and straight ones) per call, CUDA events."""
    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.models import fused as F
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3
    from fastdepth_tpu_torch.ops.cuda import head as K4

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
            "v2": (lambda: F.apply_fastdepth_fused_v2(p, xd, cfg), K2),
            "v3": (lambda: F.apply_fastdepth_fused_v3(p, xd, cfg), K3),
            "fused": (lambda: F.apply_fastdepth_fused(p, xd, cfg), K1),
            "straight": (lambda: model.apply(p, xd), None),
        }
        with torch.inference_mode():
            want = model.apply(p, xd).float()
            row = {}
            for fwd, (fn, mod) in forwards.items():
                if mod is not None and fwd != "fused":
                    _reset(mod, K4)
                    for _ in range(runs):
                        got = fn().float()
                    torch.cuda.synchronize()
                    launches = _counts(mod, K4)
                    if launches != (STAGES_PER_FORWARD * runs, runs):
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
                                "forwards": runs, "max_abs_err_vs_straight": err}
                row.setdefault(fwd, {})["forward_ms"] = _median_ms(lambda: fn(), ())
        print(f"forwards {name} b{BATCH}: {json.dumps(row)}")
        out[name] = row
    return out


def deploy_phase(model, params) -> dict:
    """cli.deploy.main on a seeded 224x224 rgb npy with the trained
    weights, f32 and --bf16, with randomized-input timing.  Every call of
    the forward launches K1 five times and K4 once; the f32 prediction is
    held against the straight forward (1e-3)."""
    from fastdepth_tpu_torch.cli import deploy
    from fastdepth_tpu_torch.engine.aot import compile_forward
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import head as K4

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
            _reset(K1, K4)
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                deploy.main(["--model", WEIGHTS, "--input-fp", in_fp, "--output-fp", out_fp,
                             "--warmup", str(DEPLOY_WARMUP), "--run", str(DEPLOY_RUN),
                             "--randomized-input-timing", "--device", "cuda"] + extra)
            torch.cuda.synchronize()
            for line in log.getvalue().splitlines():
                print(f"deploy {name}: {line}")
            k1, k4 = _counts(K1, K4)
            if (k1, k4) != (STAGES_PER_FORWARD * calls, calls):
                fail(f"deploy {name}: K1 launched {k1} and K4 {k4} times over {calls} "
                     f"calls, want {STAGES_PER_FORWARD} and 1 per call")
            pred = np.load(out_fp)
            if pred.shape != (1, 1, *OUTPUT_HW) or not np.isfinite(pred).all():
                fail(f"deploy {name}: saved prediction of shape {pred.shape}, finite: "
                     f"{bool(np.isfinite(pred).all())}")
            timed = re.search(r"\[timed\] mean=([\d.]+) ms  median=([\d.]+) ms", log.getvalue())
            rand = re.search(r"\[randomized\] mean=([\d.]+) ms  median=([\d.]+) ms",
                             log.getvalue())
            out[name] = {"launches": k1, "k4_launches": k4, "calls": calls,
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


def fresh_deploy_f32(in_fp: str, out_fp: str, want: np.ndarray) -> dict:
    """cli.deploy.main in f32 in a fresh process, whose TF32 flags start
    at PyTorch's defaults (cuDNN's on): the CLI must turn both off, and
    its saved prediction must agree with ``want``, the straight forward
    with TF32 off, within 1e-3."""
    argv = ["--model", WEIGHTS, "--input-fp", in_fp, "--output-fp", out_fp, "--warmup", "2",
            "--run", "5", "--device", "cuda"]
    code = ("import json, torch\n"
            "def flags():\n"
            "    return [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]\n"
            "before = flags()\n"
            "from fastdepth_tpu_torch.cli import deploy\n"
            f"deploy.main({argv!r})\n"
            "print('TF32 ' + json.dumps({'before': before, 'after': flags()}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        fail(f"deploy in a fresh process exited {r.returncode}: {r.stderr[-2000:]}")
    flags = json.loads(r.stdout.rsplit("TF32 ", 1)[1])
    pred = np.load(out_fp)
    err = float(np.abs(pred - want).max())
    print(f"deploy f32, fresh process: TF32 flags (cudnn, matmul) {flags['before']} before, "
          f"{flags['after']} after; saved prediction vs straight forward max|diff| {err:.3e} "
          "(bound 1e-3)")
    if flags["after"] != [False, False]:
        fail(f"deploy in f32 left TF32 on: {flags['after']}")
    if not err <= 1e-3:
        fail(f"fresh-process f32 deploy disagrees with the straight forward: {err}")
    return {"tf32_before": flags["before"], "tf32_after": flags["after"],
            "max_abs_err_vs_straight": err}


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
    from fastdepth_tpu_torch.ops.cuda import probes as KP

    device = torch.device("cuda")
    KP.COPY_LAUNCHES = KP.STAGE_LAUNCHES = 0
    for tag in P.PROBES:
        out = P.run(tag, device)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"probe {tag}: non-finite output")
    launches = {"K5": KP.COPY_LAUNCHES, "K6": KP.STAGE_LAUNCHES}
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


def tools_phase() -> dict:
    """engine/calibrate at a reduced call count, then cli.profile --mode
    prefix at batch 128 on the pruned flagship (f32, random weights) on
    those ceilings: 20 finite rows, and the summed bounds at most the
    measured full forward."""
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
            "profile_sum_bounds_us": prof["sum_bounds_us"]}


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
]


def main() -> None:
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    kernels = kernel_phase()
    model, params = load_weights()
    e2e = e2e_phase(model, params)
    fwd = forwards_phase(model, params)
    dep = deploy_phase(model, params)
    kernels.update(probe_phase())
    tools_phase()
    # launches: each kernel's count on the f32 run of its path (K1: the
    # eval path, K2/K3: the v2/v3 forwards, K4: the deploy path, K5/K6:
    # the probe catalogue's run); ms / plain_ms: device time (events_ms
    # beside it), f32, batch 8, summed over the pruned flagship's five
    # levels (K4: its head; K5/K6: over their probe tags), with the worst
    # f32 error over the checked shapes; bound_ms the least time for the
    # same calls' work at the H100's published rates (summed likewise),
    # bound_by the term that binds most of it; library_ms one PyTorch call
    # per call where one computes the same function, else null (K5 and K6:
    # summed over library_tags, beside ms_over_library_tags, the kernel's
    # own time over the same tags)
    launches = {"K1": e2e["f32"]["launches"], "K2": fwd["f32"]["v2"]["launches"],
                "K3": fwd["f32"]["v3"]["launches"], "K4": dep["f32"]["k4_launches"],
                "K5": kernels["K5"]["launches"], "K6": kernels["K6"]["launches"]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces or kernels[key]["replaces"], "launches": launches[key],
        "max_abs_err": kernels[key]["max_abs_err"], "ms": kernels[key]["ms"],
        "plain_ms": kernels[key]["plain_ms"], "bound_ms": kernels[key]["bound_ms"],
        "bound_by": kernels[key]["bound_by"], "library_ms": kernels[key]["library_ms"],
        "events_ms": kernels[key]["events_ms"],
        "plain_events_ms": kernels[key]["plain_events_ms"],
        **{f: kernels[key][f] for f in ("library_tags", "ms_over_library_tags")
           if f in kernels[key]},
    } for key, name, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
