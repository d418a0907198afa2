"""Evaluation CLI on the PyTorch/CUDA port — the ``main.py --evaluate``
equivalent (reference main.py:26-60, utils.py:12-34), counterpart of
``fastdepth_tpu/cli/evaluate.py``.

Usage:
    python -m fastdepth_tpu_torch.cli.evaluate --evaluate CKPT --data-root DIR [...]

CKPT is a native .npz checkpoint or a reference PyTorch .pth[.tar]
pickle, converted on load by the port's copy of the converter
(unpickling a full-module checkpoint executes code: pass TRUSTED .pth
files only).  Extras over the reference CLI: --batch-size, --bf16,
--no-fold-bn, --impl, --device-normalize, --no-images, --split, --csv,
--device.
"""

from __future__ import annotations

import argparse
import os

import torch

from fastdepth_tpu_torch.engine.aot import IMPLS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth evaluation (PyTorch/CUDA port)")
    # reference flags (utils.py:12-34)
    p.add_argument("--data", metavar="DATA", default="nyudepthv2",
                   choices=["nyudepthv2"], help="dataset name")
    p.add_argument("--data-root", default=os.path.join("..", "data"),
                   help="datasets directory (reference hardcodes ../data, main.py:31)")
    p.add_argument("--modality", "-m", default="rgb", choices=["rgb"])
    p.add_argument("-j", "--workers", default=8, type=int, metavar="N")
    p.add_argument("--print-freq", "-p", default=50, type=int, metavar="N")
    p.add_argument("-e", "--evaluate", required=True, type=str, metavar="PATH")
    # port flags
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--bf16", action="store_true", help="run the model in bfloat16")
    p.add_argument("--no-fold-bn", action="store_true",
                   help="keep BatchNorm unfolded (exact reference numerics)")
    p.add_argument("--impl", default="auto", choices=list(IMPLS),
                   help="forward: auto = decoder levels through the fused CUDA "
                        "kernel when the architecture allows and BN is folded")
    p.add_argument("--no-images", action="store_true", help="skip comparison PNGs")
    p.add_argument("--split", default="val", choices=["val", "holdout"],
                   help="dataset split (holdout = the two NetAdapt files, nyu.py:13-24)")
    p.add_argument("--device-normalize", action="store_true",
                   help="send uint8 RGB and /255 on the device (less host->device transfer)")
    p.add_argument("--csv", default=None, help="append final metrics to this CSV")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions")
    return p.parse_args(argv)


def load_params_and_model(path: str):
    """Dispatch on checkpoint format; returns (params on the CPU, Model, meta)."""
    from fastdepth_tpu_torch.checkpoint import params_from_jax
    from fastdepth_tpu_torch.models import build

    if path.endswith(".npz"):
        from fastdepth_tpu_torch.checkpoint.io import load_checkpoint

        tree, cfg, meta = load_checkpoint(path)
    else:
        from fastdepth_tpu_torch.checkpoint.convert import convert_checkpoint

        tree, cfg, meta = convert_checkpoint(path)
    model = build(cfg)
    return model.load(params_from_jax(tree)), model, meta


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    if not os.path.isfile(args.evaluate):
        raise SystemExit(f"=> no model found at '{args.evaluate}'")
    print(f"=> loading model '{args.evaluate}'")
    params, model, meta = load_params_and_model(args.evaluate)
    print(f"=> loaded model (epoch {meta.get('epoch', 0)})")

    from fastdepth_tpu_torch.data import BatchLoader, NYUDataset
    from fastdepth_tpu_torch.engine import Evaluator, validate

    print("=> creating data loaders...")
    valdir = os.path.join(args.data_root, args.data, "val")
    dataset = NYUDataset(valdir, split=args.split, modality=args.modality,
                         device_normalize=args.device_normalize)
    loader = BatchLoader(dataset, batch_size=args.batch_size,
                         num_workers=args.workers, pad_last=True)
    print("=> data loaders created.")

    evaluator = Evaluator(
        model, params,
        batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        fold_bn=not args.no_fold_bn,
        impl=args.impl,
        device=args.device,
    )
    return validate(
        loader, evaluator,
        epoch=meta.get("epoch", 0),
        print_freq=args.print_freq,
        output_dir=os.path.dirname(os.path.abspath(args.evaluate)),
        make_images=not args.no_images,
        write_to_file=args.csv is not None,
        csv_path=args.csv,
    )


if __name__ == "__main__":
    main()
