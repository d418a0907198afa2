"""Deploy runner on the PyTorch/CUDA port — the counterpart of
``fastdepth_tpu/cli/deploy.py`` and of the reference's TVM runner
(reference deploy/tx2_run_tvm.py:7-91).

It loads a checkpoint, prepares the forward for the fixed input shape at
batch 1 (``engine/aot.compile_forward``: fold, cast, kernels built and
run once), feeds a golden npy input, saves the prediction npy in the
reference's NCHW layout, and reports warmup + repeat timings (also with
fresh random inputs).  ``--save-bundle PREFIX`` also writes the deploy
artifact pair ``PREFIX.pt2`` + ``PREFIX.npz`` (``engine/aot.save_bundle``:
the ``torch.export`` program, K1 and K4 as custom-op nodes, and the
folded params); ``--load-bundle PREFIX`` runs such a pair instead of a
checkpoint, the reference runner's own flow (tx2_run_tvm.py:13-26 loads
its compiled artifact set).  On the flagship, ``--impl auto`` runs the decoder
levels through K1 and the head through K4; ``--impl mixed --tuning
tuning/h100.<model>.json`` each level on the kernel that won on the card
(``engine/autotune.py``), the analogue of the reference's AutoTVM-tuned
deploy artifact.

Usage:
    python -m fastdepth_tpu_torch.cli.deploy --model CKPT --input-fp rgb.npy \\
        [--output-fp pred.npy] [--warmup 10] [--run 100] [--bf16] [--device cuda|cpu] \\
        [--save-bundle PREFIX]
    python -m fastdepth_tpu_torch.cli.deploy --load-bundle PREFIX --input-fp rgb.npy \\
        [--output-fp pred.npy] [--device cuda|cpu]
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
                     help="run a prebuilt <PREFIX>.pt2 + .npz deploy bundle (from "
                          "--save-bundle) instead of a checkpoint: the reference "
                          "runner's own flow (tx2_run_tvm.py:13-26 loads its compiled "
                          "artifact set)")
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
                   help="also write the deploy artifact pair <PREFIX>.pt2 (torch.export "
                        "program) + <PREFIX>.npz (folded params), the analogue of the "
                        "reference's TVM deploy_lib/graph/params bundle")
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
    if args.model:
        if not os.path.isfile(args.model):
            raise SystemExit(f"=> no model found at '{args.model}'")
        check_tuning_flags(args.impl, args.tuning)
    else:
        if not os.path.isfile(args.load_bundle + ".pt2"):
            raise SystemExit(f"=> no bundle found at '{args.load_bundle}.pt2'")
        # flag conflicts fail before the bundle loads
        if args.bf16:
            raise SystemExit("--bf16 has no effect on a prebuilt bundle "
                             "(precision was baked in at --save-bundle time)")
        if args.impl != "auto" or args.tuning:
            raise SystemExit("--impl/--tuning have no effect on a prebuilt "
                             "bundle (the kernel choice was baked in at "
                             "--save-bundle time)")
        if args.save_bundle:
            raise SystemExit("--save-bundle requires --model (a bundle is "
                             "already the saved artifact)")
    if args.model and not args.bf16:
        strict_f32()  # f32 is true f32; a bundle sets it from its own dtype
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")

    from fastdepth_tpu_torch.engine.benchmark import time_fn, time_randomized
    from fastdepth_tpu_torch.engine.profiler import trace

    x_np = load_input(args.input_fp)
    h, w = x_np.shape[1], x_np.shape[2]
    device = torch.device(args.device)

    if args.load_bundle:
        from fastdepth_tpu_torch.engine.aot import load_bundle

        print(f"=> loading bundle '{args.load_bundle}'")
        forward, prepared, _, spec = load_bundle(args.load_bundle, device=device)
        want = (spec.get("batch_size", 1), *spec.get("image_size", (h, w)), 3)
        if tuple(x_np.shape) != tuple(want):
            raise SystemExit(
                f"=> bundle expects input {tuple(want)} "
                f"({spec.get('dtype', 'float32')} compute), got {x_np.shape} "
                f"from '{args.input_fp}'")
    else:
        from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
        from fastdepth_tpu_torch.engine.aot import compile_forward, flops_estimate

        dtype = torch.bfloat16 if args.bf16 else torch.float32
        print(f"=> loading model '{args.model}'")
        params, model, _ = load_params_and_model(args.model)
        print(f"=> compiling for {x_np.shape} ({str(dtype).replace('torch.', '')}, "
              f"{args.device})")
        forward, prepared = compile_forward(
            model, params, batch_size=1, image_size=(h, w), dtype=dtype, impl=args.impl,
            tuning=args.tuning, device=device)
        fl = flops_estimate(model, prepared, batch_size=1, image_size=(h, w))
        print(f"=> compiled; {fl / 1e9:.3f} GFLOP/frame")

    x = torch.from_numpy(x_np).to(device)
    pred = forward(prepared, x).cpu().numpy()
    np.save(args.output_fp, np.transpose(pred, (0, 3, 1, 2)))  # NCHW like the reference
    print(f"=> saved prediction to {args.output_fp}")

    if args.save_bundle:
        from fastdepth_tpu_torch.engine.aot import save_bundle

        save_bundle(args.save_bundle, model, params, batch_size=1, image_size=(h, w),
                    dtype=dtype, impl=args.impl, tuning=args.tuning, device=device)
        print(f"=> saved bundle {args.save_bundle}.pt2 + .npz")

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
