#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and turns TF32 off for the f32 phases;
2. build: compiles every kernel of the port from fastdepth_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version, on the card,
   at the shapes the flagship's main path gives it (f32 and bf16), with
   both times (CUDA events);
4. end to end: the committed trained weights (docs/rehearsal_model_r5.npz)
   -> build -> fold -> Evaluator(impl='auto') -> validate() over seeded
   raw 480x640 frames put through the shared val pipeline, at f32 and
   bf16; counts K1's launches on that run, and holds the fused forward
   against the port's straight (plain PyTorch) forward;
5. prints the kernels' JSON line, then the result line.

The port reuses the JAX package's jax-free modules (config, the data
pipeline, the npz checkpoint reader); nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "docs", "rehearsal_model_r5.npz")
BATCH = 8
E2E_BATCHES = 4
STAGES_PER_FORWARD = 5

# (H=W, C, Cout, skip) of the decoder levels K1 runs: the pruned flagship's
# five, then the unpruned model's first
PRUNED_STAGES = [(7, 512, 200, False), (14, 200, 256, True), (28, 256, 120, True),
                 (56, 120, 56, True), (112, 56, 16, False)]
UNPRUNED_STAGE1 = (7, 1024, 512, False)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the port on the GPU "
             "and has no CPU fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          "TF32 off for cuDNN convolutions and matmuls (f32 phases are true f32)")


def build_phase() -> None:
    from fastdepth_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    print(f"build: {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


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
    """Per-call device time: the median over ``repeats`` runs of ``calls``
    pipelined calls, each run timed with CUDA events."""
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    return float(np.median([time_pipelined(fn, args, calls=calls)["mean_s"]
                            for _ in range(repeats)])) * 1e3


def kernel_phase() -> dict:
    """K1 vs its plain version at the main path's shapes.  f32 bound:
    max|K1 - plain| <= 1e-4 * max(1, max|plain|) (different summation
    order only); bf16: the plain version runs in f32 on the same bf16
    inputs and is rounded, bound 2^-7 * max|plain| (one bf16 rounding of
    the output, plus the order)."""
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K

    rng = np.random.RandomState(0)
    worst_f32, k1_ms, plain_ms = 0.0, 0.0, 0.0
    shapes = [("pruned", s) for s in PRUNED_STAGES] + [("unpruned", UNPRUNED_STAGE1)]
    for dtype in (torch.float32, torch.bfloat16):
        for which, (h, c, cout, skip) in shapes:
            args = _stage_inputs(rng, BATCH, h, c, cout, skip, dtype)
            with torch.inference_mode():
                before = K.LAUNCHES
                got = K.fused_decoder_stage(*args)
                if K.LAUNCHES != before + 1:
                    fail("the wrapper did not launch K1 on a CUDA tensor")
                want = K.fused_decoder_stage_reference(*args)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                bound = (1e-4 * max(1.0, scale) if dtype == torch.float32
                         else 2.0 ** -7 * scale)
                t_k = _median_ms(K.fused_decoder_stage, args)
                t_p = _median_ms(K.fused_decoder_stage_reference, args)
            name = "f32" if dtype == torch.float32 else "bf16"
            row = {"dtype": name, "model": which, "H": h, "C": c, "Cout": cout,
                   "skip": skip, "batch": BATCH, "max_abs_err": err, "bound": bound,
                   "max_abs_plain": scale, "k1_ms": t_k, "plain_ms": t_p}
            print(f"K1 {name} {which} {h}x{h} {c}->{cout}{' +skip' if skip else ''} "
                  f"b{BATCH}: max|diff| {err:.3e} (bound {bound:.3e}), "
                  f"K1 {t_k:.4f} ms, plain {t_p:.4f} ms")
            if not (err <= bound) or not torch.isfinite(got.float()).all():
                fail(f"K1 disagrees with its plain version: {row}")
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err)
                if which == "pruned":
                    k1_ms += t_k
                    plain_ms += t_p
    return {"max_abs_err": worst_f32, "ms": k1_ms, "plain_ms": plain_ms}


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


def e2e_phase() -> dict:
    from fastdepth_tpu_torch import (OUTPUT_SIZE, RAW_SIZE, Evaluator, ValPipeline,
                                     build, load_checkpoint, params_from_jax, validate)
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K

    tree, cfg, _ = load_checkpoint(WEIGHTS)
    model = build(cfg)
    params = model.load(params_from_jax(tree))
    loader = _Frames(_frames(ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE),
                             seed=0))
    rgb0, depth0, _ = loader.batches[0]
    forwards = E2E_BATCHES + 1  # validate() warms up on the first batch
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ev = Evaluator(model, params, batch_size=BATCH, dtype=dtype, impl="auto",
                       device="cuda")
        K.LAUNCHES = 0
        avg = validate(loader, ev, print_freq=0, make_images=False,
                       log=lambda s: print(s.strip().replace("\n", " ")))
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        if launches != STAGES_PER_FORWARD * forwards:
            fail(f"{name}: K1 launched {launches} times over {forwards} forwards, "
                 f"want {STAGES_PER_FORWARD} per forward")
        x, d = ev.put(rgb0), ev.put(depth0)
        pred, _ = ev(x, d)
        torch.cuda.synchronize()
        if tuple(pred.shape) != (BATCH, *OUTPUT_SIZE, 1) or not torch.isfinite(pred).all():
            fail(f"{name}: predictions of shape {tuple(pred.shape)}, finite: "
                 f"{bool(torch.isfinite(pred).all())}")
        fps = BATCH / _median_ms(ev, (x, d)) * 1e3
        row = {k: getattr(avg, k) for k in ("rmse", "mae", "delta1", "absrel", "lg10")}
        out[name] = {"launches": launches, "forwards": forwards, "metrics": row,
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


def main() -> None:
    device_phase()
    build_phase()
    kernels = kernel_phase()
    e2e = e2e_phase()
    print(json.dumps({"kernels": [{
        "name": "fused_decoder_stage",
        "route": "cuda",
        "source": "fastdepth_tpu_torch/csrc/fused_decoder.cu",
        "replaces": "fastdepth_tpu/ops/pallas/fused_decoder.py:50",
        "launches": e2e["f32"]["launches"],
        # worst f32 error over the checked shapes; ms: the five pruned
        # levels at batch 8, f32, summed (one forward's decoder)
        "max_abs_err": kernels["max_abs_err"],
        "ms": kernels["ms"],
        "plain_ms": kernels["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
