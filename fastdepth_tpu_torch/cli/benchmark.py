"""End-to-end streaming benchmark on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/benchmark.py``: the HDF5 loader, the host transforms
and the batched work on the card measured as one pipeline, loader
threads, host-to-device copies, the model and the metrics overlapping.

Two modes:

* default: evaluation (``validate()`` over the val split), frames/s;
  ``--device-preprocess`` ships raw 480x640 frames and runs the val
  resize/crop gather on the card (``Evaluator(val_pipeline=...)``);
* ``--train``: one full training pass (the augmentation chain, the
  ``Trainer`` step with BatchNorm batch statistics), train frames/s;
  ``--device-augment`` ships raw frames and the augmentation's parameters
  and augments on the card (``data/device_aug.py``).

Usage:
    python -m fastdepth_tpu_torch.cli.benchmark [--evaluate CKPT] [--data-root D]
        [--synthetic N] [--batch-size 64] [--bf16] [--device-preprocess]
        [--train [--device-augment]] [--device cuda|cpu] [--json]

Without ``--data-root``, ``--synthetic N`` writes an NYU-layout h5 tree of
N seeded frames (the JAX CLI's) into a temporary directory first; it
needs ``h5py``.  f32 is true f32 (TF32 off).  The times are host-clock
spans that end in a fetch from the device, on the device the result
names.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from fastdepth_tpu_torch.engine.aot import strict_f32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="streaming inference benchmark (PyTorch/CUDA port)")
    p.add_argument("-e", "--evaluate", default=None,
                   help="checkpoint; default: random-init pruned FastDepth")
    p.add_argument("--data", default="nyudepthv2")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic", type=int, default=256,
                   help="frames of synthetic data when no --data-root (needs h5py)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="run the model in bfloat16; without it f32 is true f32 (TF32 off)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="eval mode: ship raw 480x640 frames and run the val resize/crop "
                        "gather on the device inside the step (identical values)")
    p.add_argument("--train", action="store_true",
                   help="benchmark the end-to-end TRAIN pipeline (loader + "
                        "augmentations + Trainer step) instead of eval")
    p.add_argument("--device-augment", action="store_true",
                   help="with --train: run the whole augmentation chain on the device "
                        "inside the train step (the host ships raw frames + per-item "
                        "gather maps/jitter grids; bit-identical items)")
    p.add_argument("--worker-mode", default="thread", choices=["thread", "process"],
                   help="loader worker model: GIL-sharing threads (h5py/native kernels "
                        "release the GIL) or spawned worker processes (the torch "
                        "num_workers model, reference main.py:40-41)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs on the card (the port's kernels); cpu runs their plain "
                        "PyTorch versions, and the times are CPU times")
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    args = p.parse_args(argv)
    if args.device_augment and not args.train:
        p.error("--device-augment takes --train")
    if args.device_preprocess and args.train:
        p.error("--device-preprocess is for the eval mode, not --train")
    return args


def make_synthetic_tree(n: int, split: str, root: str) -> str:
    """An NYU-layout tree of ``n`` seeded h5 frames under ``root``, the JAX
    CLI's frames; returns ``root``.  Exits naming ``h5py`` where it is not
    installed."""
    import numpy as np

    try:
        import h5py
    except ImportError:
        raise SystemExit("--synthetic writes an h5 tree and needs h5py, which is not "
                         "installed: pass --data-root DIR") from None
    d = os.path.join(root, "nyudepthv2", split, "scene_0")
    os.makedirs(d)
    rng = np.random.RandomState(0)
    # stems 00001/00201 are the holdout files the train split filters out
    # (data/nyu.py): skip them so the tree holds exactly n train items
    stems = (k for k in range(n + 2) if split != "train" or k not in (1, 201))
    for _ in range(n):
        with h5py.File(os.path.join(d, f"{next(stems):05d}.h5"), "w") as f:
            f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    return root


def _device_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are

    from fastdepth_tpu_torch.data import NYUDataset

    if args.evaluate:
        from fastdepth_tpu_torch.cli.evaluate import load_params_and_model

        params, model, _ = load_params_and_model(args.evaluate)
    else:
        from fastdepth_tpu_torch.models import fastdepth_pruned

        model = fastdepth_pruned()
        params = model.init(torch.Generator().manual_seed(0))

    split = "train" if args.train else "val"
    with contextlib.ExitStack() as stack:
        data_root = args.data_root
        if data_root is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="fd_synth_"))
            data_root = make_synthetic_tree(args.synthetic, split, root=tmp)
        path = os.path.join(data_root, args.data, split)
        if args.train:
            dataset = NYUDataset(path, split="train", device_augment=args.device_augment)
            return train_run(dataset, model, params, args)
        dataset = NYUDataset(path, split="val", device_normalize=True,
                             raw_items=args.device_preprocess)
        return eval_run(dataset, model, params, args)


def eval_run(dataset, model, params, args) -> dict:
    """Streaming eval frames/s over ``dataset`` (val items; raw frames
    when it was built with ``raw_items=True``, gathered on the device):
    one warm-up pass of ``validate()``, then one timed pass."""
    from fastdepth_tpu_torch.data import BatchLoader
    from fastdepth_tpu_torch.engine import Evaluator, validate

    loader = BatchLoader(dataset, batch_size=args.batch_size, num_workers=args.workers,
                         pad_last=True, worker_mode=args.worker_mode)
    evaluator = Evaluator(
        model, params, batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        val_pipeline=dataset.val_pipeline if dataset.raw_items else None,
        device=args.device,
    )

    def one_pass():
        validate(loader, evaluator, print_freq=0, make_images=False, log=lambda *a: None)

    one_pass()  # warm-up: the kernels' build, cuDNN's search, the allocator
    t0 = time.perf_counter()
    one_pass()
    elapsed = time.perf_counter() - t0
    result = {
        "metric": "end-to-end streaming eval fps (h5 -> transforms -> device -> metrics)",
        "frames": len(dataset),
        "batch_size": args.batch_size,
        "dtype": "bf16" if args.bf16 else "fp32",
        "elapsed_s": round(elapsed, 3),
        "fps": round(len(dataset) / elapsed, 1),
        "workers": args.workers,
        "device_preprocess": bool(dataset.raw_items),
        "device": _device_name(args.device),
    }
    print(json.dumps(result) if args.json else
          f"=> {result['frames']} frames in {result['elapsed_s']}s = {result['fps']} fps "
          f"(batch {args.batch_size}, {result['dtype']}, {result['device']})")
    return result


def train_run(dataset, model, params, args) -> dict:
    """End-to-end train frames/s over ``dataset`` (train items; raw frames
    plus parameters when it was built with ``device_augment=True``,
    augmented on the device): the threaded loader (h5 read, and on the
    host path the composed rotate-gather and ColorJitter) feeding the
    full ``Trainer`` step (forward, backward, SGD update, BatchNorm
    statistics merge); one warm-up pass, then one timed pass."""
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.data import BatchLoader
    from fastdepth_tpu_torch.train import Trainer

    trainer = Trainer(
        model, params, TrainConfig(lr=0.01, batch_size=args.batch_size),
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        device_augment=dataset.device_augment, device=args.device,
    )

    def one_pass(epoch):
        loader = BatchLoader(dataset, batch_size=args.batch_size, shuffle=True,
                             num_workers=args.workers, drop_last=True, pad_last=False,
                             seed=0, worker_mode=args.worker_mode)
        loader.set_epoch(epoch)
        return trainer.run_epoch(loader, epoch, print_freq=0, log=lambda *a: None)

    one_pass(0)  # warm-up
    t0 = time.perf_counter()
    loss = one_pass(1)
    elapsed = time.perf_counter() - t0
    frames = (len(dataset) // args.batch_size) * args.batch_size
    result = {
        "metric": "end-to-end streaming TRAIN fps "
                  "(h5 -> augmentations -> device -> sgd step)",
        "frames": frames,
        "batch_size": args.batch_size,
        "dtype": "bf16" if args.bf16 else "fp32",
        "workers": args.workers,
        "worker_mode": args.worker_mode,
        "device_augment": bool(dataset.device_augment),
        "elapsed_s": round(elapsed, 3),
        "fps": round(frames / elapsed, 1),
        "final_loss": round(float(loss), 4),
        "device": _device_name(args.device),
    }
    print(json.dumps(result) if args.json else
          f"=> {frames} frames in {result['elapsed_s']}s = {result['fps']} "
          f"train-fps (batch {args.batch_size}, {result['dtype']}, "
          f"{args.workers} workers, {result['device']})")
    return result


if __name__ == "__main__":
    main()
