#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and turns TF32 off for the f32 phases;
2. build: compiles every kernel of the port from fastdepth_tpu_torch/csrc;
3. kernels: each kernel (K1-K4) against its plain PyTorch version, on
   the card, at the shapes the flagship's paths give it (f32 and bf16),
   with both device times (CUDA events around a CUDA graph of the calls)
   and, beside them, CUDA-event times of pipelined calls (which count the
   host's launch time when a call is shorter than it);
4. eval path: the committed trained weights (docs/rehearsal_model_r5.npz)
   -> build -> fold -> Evaluator(impl='auto') -> validate() over seeded
   raw 480x640 frames put through the shared val pipeline, at f32 and
   bf16; counts K1's and K4's launches on that run, and holds the fused
   forward against the port's straight (plain PyTorch) forward;
5. v2 / v3 forwards: the same weights through K2 or K3 and K4 at batch
   8, held against the straight forward, with their launch counts;
6. deploy path: cli.deploy.main on a seeded 224x224 rgb npy, f32 and
   --bf16, with randomized-input timing; its saved prediction against the
   straight forward, and K1's and K4's launches on every call;
7. probes: every tag of the probe catalogue (engine/probes.py, the
   scripts' Pallas probes) runs its kernel (K5, K6, or K3) once, with
   K5's and K6's launches counted on that run; then each kernel against
   its plain version with both times, and K5's copy sweep (dma_copy);
8. tools: engine/calibrate (reduced call count) measures the card's
   ceilings, and cli.profile --mode prefix --batch 128 profiles the
   pruned flagship on them; the summed roofline bounds must not exceed
   the measured full forward;
9. prints the kernels' JSON line, then the result line.

The port reuses the JAX package's jax-free modules (config, the data
pipeline, the npz checkpoint reader); nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "docs", "rehearsal_model_r5.npz")
BATCH = 8
E2E_BATCHES = 4
STAGES_PER_FORWARD = 5

DEPLOY_WARMUP, DEPLOY_RUN = 10, 50
PROBE_CALLS = 10
CALIBRATE_CALLS = 3
PROFILE_CALLS = 5
OUTPUT_HW = (224, 224)

# (H=W, C, Cout, skip) of the decoder levels K1-K3 run: the pruned
# flagship's five, then the unpruned model's first
PRUNED_STAGES = [(7, 512, 200, False), (14, 200, 256, True), (28, 256, 120, True),
                 (56, 120, 56, True), (112, 56, 16, False)]
UNPRUNED_STAGE1 = (7, 1024, 512, False)
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _stage_inputs(rng, n, h, c, cout, skip, dtype):
    """Seeded stage operands on the card: x and skip channels_last, the
    weights in K1's layout, scaled so activations stay O(1)."""
    def t(a, cl=False):
        a = torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
        return a.contiguous(memory_format=torch.channels_last) if cl else a
    x = t(rng.randn(n, c, h, h), cl=True)
    dw_w = t(rng.randn(25, c) * 0.2)
    dw_b = t(rng.randn(c) * 0.1)
    pw_w = t(rng.randn(c, cout) / np.sqrt(c))
    pw_b = t(rng.randn(cout) * 0.1)
    sk = t(rng.randn(n, cout, 2 * h, 2 * h), cl=True) if skip else None
    return x, dw_w, dw_b, pw_w, pw_b, sk


def _median_ms(fn, args, repeats: int = 5, calls: int = 20) -> float:
    """Per-call time of a step or forward: the median over ``repeats``
    runs of ``calls`` pipelined calls, each run timed with CUDA events
    (host launch time included where the device waits for it)."""
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    return float(np.median([time_pipelined(fn, args, calls=calls)["mean_s"]
                            for _ in range(repeats)])) * 1e3


def _kernel_ms(fn, args, calls: int = 20):
    """(device ms, events ms) per call: CUDA events around a CUDA graph of
    ``calls`` calls (the kernels back to back, no host launch time), and
    the median CUDA-event time of pipelined calls."""
    from fastdepth_tpu_torch.engine.benchmark import time_graph

    return time_graph(fn, args, calls=calls) * 1e3, _median_ms(fn, args, repeats=3,
                                                                  calls=calls)


def _check_kernel(label, mod, fn, plain, args, kwargs, dtype):
    """One kernel launch against its plain version: (max|diff|, bound,
    max|plain|, (kernel device ms, events ms), (plain device ms, events
    ms)).  f32 bound: max|diff| <=
    1e-4 * max(1, max|plain|) (different summation order only); bf16:
    the plain version runs in f32 on the same bf16 inputs and is rounded,
    bound 2^-7 * max|plain| (one bf16 rounding of the output, plus the
    order).  These launches are not counted for the paths below."""
    with torch.inference_mode():
        before = mod.LAUNCHES
        got = fn(*args, **kwargs)
        if mod.LAUNCHES != before + 1:
            fail(f"the wrapper did not launch {label} on a CUDA tensor")
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        bound = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale
        if not (err <= bound) or not torch.isfinite(got.float()).all():
            fail(f"{label} disagrees with its plain version: max|diff| {err} > {bound}")
        t_k = _kernel_ms(lambda *a: fn(*a, **kwargs), args)
        t_p = _kernel_ms(plain, args)
    return err, bound, scale, t_k, t_p


def kernel_phase() -> dict:
    """K1-K3 at every decoder level of the flagship (and the unpruned
    model's first), each at the images per block its forward gives that
    level; K4 at the heads.  Returns per kernel: the worst f32 error, and
    the f32 device and event times summed over the pruned flagship's five
    levels (K4: its head), kernel and plain."""
    from fastdepth_tpu_torch.models import fused as F
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3
    from fastdepth_tpu_torch.ops.cuda import head as K4

    stage_kernels = [
        ("K1", K1, K1.fused_decoder_stage, {}),
        ("K2", K2, K2.fused_decoder_stage_hwbc, F.V2_BLOCK_BATCHES),
        ("K3", K3, K3.fused_decoder_stage_v3, F.V3_BLOCK_BATCHES),
    ]
    levels = [("pruned", i, s) for i, s in enumerate(PRUNED_STAGES, start=1)]
    levels.append(("unpruned", 1, UNPRUNED_STAGE1))
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "events_ms": 0.0,
               "plain_events_ms": 0.0, "rows": []} for k in ("K1", "K2", "K3", "K4")}

    def record(row, err, t_k, t_p, dtype, pruned, **shape):
        row["rows"].append({"dtype": "f32" if dtype == torch.float32 else "bf16", **shape,
                            "ms": t_k[0], "plain_ms": t_p[0], "events_ms": t_k[1],
                            "plain_events_ms": t_p[1], "max_abs_err": err})
        if dtype == torch.float32:
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if pruned:
                for key, t in (("ms", t_k[0]), ("plain_ms", t_p[0]), ("events_ms", t_k[1]),
                               ("plain_events_ms", t_p[1])):
                    row[key] += t
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for label, mod, fn, bbs in stage_kernels:
            rng = np.random.RandomState(0)
            for which, level, (h, c, cout, skip) in levels:
                args = _stage_inputs(rng, BATCH, h, c, cout, skip, dtype)
                kwargs = {"block_batch": bbs[level]} if bbs else {}
                err, bound, scale, t_k, t_p = _check_kernel(
                    label, mod, fn, K1.fused_decoder_stage_reference, args, kwargs, dtype)
                bb = f" block_batch {bbs[level]}" if bbs else ""
                print(f"{label} {name} {which} {h}x{h} {c}->{cout}{' +skip' if skip else ''} "
                      f"b{BATCH}{bb}: max|diff| {err:.3e} (bound {bound:.3e}), device "
                      f"{label} {t_k[0]:.4f} ms, plain {t_p[0]:.4f} ms; events {label} "
                      f"{t_k[1]:.4f} ms, plain {t_p[1]:.4f} ms")
                record(out[label], err, t_k, t_p, dtype, which == "pruned", model=which, H=h,
                       C=c, Cout=cout, skip=skip)
        rng = np.random.RandomState(1)
        for which, h, c in HEADS:
            x = torch.from_numpy(rng.randn(BATCH, c, h, h).astype(np.float32)).to("cuda", dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            w = torch.from_numpy((rng.randn(c) / np.sqrt(c)).astype(np.float32)).to("cuda", dtype)
            b = torch.from_numpy(np.array([0.1], np.float32)).to("cuda", dtype)
            err, bound, scale, t_k, t_p = _check_kernel(
                "K4", K4, K4.pointwise_head, K4.pointwise_head_reference, (x, w, b), {}, dtype)
            print(f"K4 {name} {which} head {h}x{h} {c}->1 b{BATCH}: max|diff| {err:.3e} "
                  f"(bound {bound:.3e}), device K4 {t_k[0]:.4f} ms, plain {t_p[0]:.4f} ms; "
                  f"events K4 {t_k[1]:.4f} ms, plain {t_p[1]:.4f} ms")
            record(out["K4"], err, t_k, t_p, dtype, which == "pruned", model=which, H=h, C=c)
    for label, row in out.items():
        print(f"{label} f32 sum over the pruned flagship's "
              f"{'head' if label == 'K4' else 'five levels'}: device {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms; events {row['events_ms']:.4f} ms, plain "
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
            print(f"deploy {name}: {json.dumps(out[name])}")
    return out


def probe_phase() -> dict:
    """The probe catalogue on the card.  The slice's path: every tag's
    kernel once, with K5's and K6's counts set to 0 just before and read
    just after.  Then each kernel against its plain version on the same
    inputs (copies bit for bit; f32 compute 1e-4 * max(1, max|plain|);
    bf16 2^-7 * max|plain|), with device and event times, and K5's copy
    sweep.  Returns per kernel (K5, K6) its launches, worst error and
    device/event times summed over its tags."""
    from fastdepth_tpu_torch.cli import probe as probe_cli
    from fastdepth_tpu_torch.engine import probes as P
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
    rows = probe_cli.run_probes(list(P.PROBES), device, calls=PROBE_CALLS,
                                log=lambda s: print(f"probe {s}"))
    bad = [r["tag"] for r in rows if not r["ok"]]
    if bad:
        fail(f"probes disagree with their plain versions or failed: {bad}")
    out = {}
    for k in launches:
        mine = [r for r in rows if r["kernel"] == k]
        out[k] = {"launches": launches[k], "max_abs_err": max(r["max_abs_err"] for r in mine),
                  "ms": sum(r["device_us"] for r in mine) / 1e3,
                  "plain_ms": sum(r["plain_device_us"] for r in mine) / 1e3,
                  "events_ms": sum(r["events_us"] for r in mine) / 1e3,
                  "plain_events_ms": sum(r["plain_events_us"] for r in mine) / 1e3,
                  "replaces": P.replaces(k)}
    sweep = P.copy_sweep(device, calls=PROBE_CALLS)
    print(f"copy sweep (K5, pure copy; {P.L2_NOTE}):")
    for r in sweep:
        print(f"  {r['bytes'] >> 20} MB, {r['chunk_bytes'] >> 10} KB per slot (script "
              f"chunk_rows {r['script_chunk_rows']}), prefetch {int(r['prefetch'])}: "
              f"{r['GBs']:.1f} GB/s device, {r['GBs_events']:.1f} GB/s events")
    out["sweep"] = sweep
    print(f"probe kernels: {json.dumps({k: v for k, v in out.items() if k != 'sweep'})}")
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
    # f32 error over the checked shapes
    launches = {"K1": e2e["f32"]["launches"], "K2": fwd["f32"]["v2"]["launches"],
                "K3": fwd["f32"]["v3"]["launches"], "K4": dep["f32"]["k4_launches"],
                "K5": kernels["K5"]["launches"], "K6": kernels["K6"]["launches"]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces or kernels[key]["replaces"], "launches": launches[key],
        "max_abs_err": kernels[key]["max_abs_err"], "ms": kernels[key]["ms"],
        "plain_ms": kernels[key]["plain_ms"], "events_ms": kernels[key]["events_ms"],
        "plain_events_ms": kernels[key]["plain_events_ms"],
    } for key, name, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
