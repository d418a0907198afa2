"""Deploy runner on the PyTorch/CUDA port — the counterpart of
``fastdepth_tpu/cli/deploy.py`` and of the reference's TVM runner
(reference deploy/tx2_run_tvm.py:7-91).

It loads a checkpoint, prepares the forward for the fixed input shape at
batch 1 (``engine/aot.compile_forward``: fold, cast, kernels built and
run once), feeds a golden npy input, saves the prediction npy in the
reference's NCHW layout, and reports warmup + repeat timings (also with
fresh random inputs).  On the flagship, ``--impl auto`` runs the decoder
levels through K1 and the head through K4; ``--impl mixed --tuning
tuning/h100.<model>.json`` each level on the kernel that won on the card
(``engine/autotune.py``), the analogue of the reference's AutoTVM-tuned
deploy artifact.

Usage:
    python -m fastdepth_tpu_torch.cli.deploy --model CKPT --input-fp rgb.npy \\
        [--output-fp pred.npy] [--warmup 10] [--run 100] [--bf16] [--device cuda|cpu]

Not ported yet: ``--save-bundle``/``--load-bundle`` (ROADMAP A19); they
are parsed under the JAX names and refused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fastdepth_tpu_torch.engine.aot import IMPLS, check_tuning_flags, strict_f32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth deploy runner (PyTorch/CUDA port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="checkpoint (.npz or torch pickle)")
    src.add_argument("--load-bundle", metavar="PREFIX",
                     help="a saved deploy bundle; not ported yet (ROADMAP A19)")
    p.add_argument("--input-fp", required=True, help="input rgb .npy (HWC in [0,1] or CHW)")
    p.add_argument("--output-fp", default="pred.npy", help="prediction .npy out")
    p.add_argument("--warmup", type=int, default=10, help="warmup trials (tx2_run_tvm.py:43)")
    p.add_argument("--run", type=int, default=100, help="timed trials (tx2_run_tvm.py:48)")
    p.add_argument("--randomized-input-timing", action="store_true",
                   help="also time with fresh random inputs (tx2_run_tvm.py:56-65)")
    p.add_argument("--bf16", action="store_true",
                   help="run the model in bfloat16; without it f32 is true f32 (TF32 off "
                        "for cuDNN's convolutions and for matmuls)")
    p.add_argument("--impl", default="auto", choices=list(IMPLS),
                   help="forward (engine/aot._pick_apply): auto = decoder levels "
                        "through K1 and the head through K4 when the architecture "
                        "allows and BN is folded; mixed = each decoder stage on its "
                        "autotuned winner from --tuning")
    p.add_argument("--tuning", default=None, metavar="JSON",
                   help="with --impl mixed: tuning record (tuning/*.json), "
                        "the analogue of the AutoTVM log the reference's "
                        "deploy artifact was compiled with")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed runs to DIR")
    p.add_argument("--save-bundle", default=None, metavar="PREFIX",
                   help="also write a deploy bundle; not ported yet (ROADMAP A19)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions (timings are then CPU times); on either, f32 "
                        "is true f32 (TF32 off)")
    return p.parse_args(argv)


def load_input(path: str) -> np.ndarray:
    """Accepts (H, W, 3), (3, H, W), or (1, 3, H, W) float arrays; returns
    (1, H, W, 3) float32 (the reference feeds 1x3x224x224 NCHW,
    tx2_run_tvm.py:28-33)."""
    arr = np.asarray(np.load(path), np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"bad input shape {arr.shape}")
    if arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (1, 2, 0))
    return arr[None]


def main(argv=None):
    args = parse_args(argv)
    if args.load_bundle or args.save_bundle:
        raise SystemExit("--save-bundle/--load-bundle are not ported yet: ROADMAP A19")
    check_tuning_flags(args.impl, args.tuning)
    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    if not os.path.isfile(args.model):
        raise SystemExit(f"=> no model found at '{args.model}'")

    from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
    from fastdepth_tpu_torch.engine.aot import compile_forward, flops_estimate
    from fastdepth_tpu_torch.engine.benchmark import time_fn, time_randomized
    from fastdepth_tpu_torch.engine.profiler import trace

    x_np = load_input(args.input_fp)
    h, w = x_np.shape[1], x_np.shape[2]
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device = torch.device(args.device)

    print(f"=> loading model '{args.model}'")
    params, model, _ = load_params_and_model(args.model)
    print(f"=> compiling for {x_np.shape} ({str(dtype).replace('torch.', '')}, {args.device})")
    forward, prepared = compile_forward(
        model, params, batch_size=1, image_size=(h, w), dtype=dtype, impl=args.impl,
        tuning=args.tuning, device=device)
    fl = flops_estimate(model, prepared, batch_size=1, image_size=(h, w))
    print(f"=> compiled; {fl / 1e9:.3f} GFLOP/frame")

    x = torch.from_numpy(x_np).to(device)
    pred = forward(prepared, x).cpu().numpy()
    np.save(args.output_fp, np.transpose(pred, (0, 3, 1, 2)))  # NCHW like the reference
    print(f"=> saved prediction to {args.output_fp}")

    with trace(args.profile):
        stats = time_fn(forward, (prepared, x), warmup=args.warmup, repeats=args.run,
                        device=device)
    print(f"=> [timed] mean={stats['mean_s'] * 1e3:.3f} ms  "
          f"median={stats['median_s'] * 1e3:.3f} ms  "
          f"({1.0 / stats['median_s']:.1f} fps)")

    if args.randomized_input_timing:
        rng = np.random.RandomState(0)

        def make_input(i):
            return torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32)).to(device)

        rstats = time_randomized(lambda v: forward(prepared, v), make_input,
                                 warmup=args.warmup, repeats=args.run, device=device)
        print(f"=> [randomized] mean={rstats['mean_s'] * 1e3:.3f} ms  "
              f"median={rstats['median_s'] * 1e3:.3f} ms")
    return stats


if __name__ == "__main__":
    main()
