"""Training CLI on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/train.py``: the full train/validate/checkpoint cycle
the reference release dropped (its main.py keeps only --evaluate; CSV
fieldnames and best-result tracking at main.py:20-24 define the harness
semantics rebuilt here; recipe per BASELINE.json config #5).

Usage:
    python -m fastdepth_tpu_torch.cli.train --data-root ../data [--epochs 20]
        [--pretrained-encoder imagenet.npz|model_best.pth.tar]
        [--arch mobilenet-nnconv5dw-skipadd] [--bf16] [--device-augment]
        [--mesh-devices N [--coord HOST:PORT --num-processes N --process-id K]]
        [--device cuda|cpu]

``--arch`` takes any name of the model registry (``models.from_name``):
the FastDepth skip models, plain MobileNet with any registry decoder
(``mobilenet-nnconv5``) and the ResNets (``resnet50-upproj``,
``resnet18-nnconv5-skipconcat``).

Writes ``train.csv``, ``test.csv``, ``model_best.npz`` and the resumable
``checkpoint.npz`` into --output-dir, in the JAX package's formats: a
checkpoint of either CLI resumes in the other.  ``--device-augment``
ships raw frames and the augmentation's parameters and augments on the
card (``data/device_aug.py``).  ``--mesh-devices N`` trains data-parallel
over N ranks, one a device (``parallel/``): spawned here, or one a process
under ``--coord`` (the JAX package's flags); every rank trains its rows of
each global batch, and only rank 0 prints and writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time

import torch

from fastdepth_tpu_torch.engine.aot import strict_f32
from fastdepth_tpu_torch.parallel import distributed as D
from fastdepth_tpu_torch.parallel.mesh import check_cli_mesh, mesh_from_cli


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth training (PyTorch/CUDA port)")
    p.add_argument("--data", default="nyudepthv2", choices=["nyudepthv2"])
    p.add_argument("--data-root", default=os.path.join("..", "data"))
    p.add_argument("--arch", default="mobilenet-nnconv5dw-skipadd")
    p.add_argument("--arch-json", default=None, metavar="JSON",
                   help="train an explicit ModelConfig loaded from a JSON "
                        "file (per-layer channel lists — how pruned nets "
                        "are specified) instead of a registry --arch name")
    D.add_distributed_args(p)
    p.add_argument("--pretrained-encoder", default=None,
                   help="ImageNet MobileNet ckpt (torch .pth.tar or .npz)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--lr-decay-step", type=int, default=5)
    p.add_argument("--lr-decay-gamma", type=float, default=0.2)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the model's init (a torch.Generator: other numbers than "
                        "the JAX CLI's PRNGKey from the same seed) and the data's "
                        "shuffles and augmentations (the same as the JAX CLI's)")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel training over N ranks, one a device (alone: "
                        "spawned on this host; with --coord: N processes)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (torch.utils.checkpoint): "
                        "trades FLOPs for activation memory at large batch/resolution")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training: bf16 forward/backward, f32 master "
                        "weights/momentum/BN statistics (no loss scaling: bf16 keeps "
                        "f32's exponent range); without it f32 is true f32 (TF32 off "
                        "for cuDNN's convolutions and for matmuls)")
    p.add_argument("--device-augment", action="store_true",
                   help="run the whole augmentation chain on the device inside the train "
                        "step (the host ships raw frames + per-item gather maps/jitter "
                        "grids; bit-identical items)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "sequential microbatches and apply one averaged update — the "
                        "memory lever when --batch-size exceeds device memory even under "
                        "--remat; batch size must be divisible by it")
    p.add_argument("--output-dir", default="results")
    p.add_argument("--eval-batch-size", type=int, default=8)
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a checkpoint.npz written by this CLI or the JAX "
                        "one: restores params, optimizer momentum, epoch counter, and "
                        "best-result tracking (arch comes from the checkpoint; --arch "
                        "is ignored)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda trains on the card (validation through the port's "
                        "kernels); cpu runs the plain PyTorch versions")
    return p.parse_args(argv)


def load_pretrained_encoder(path: str):
    """ImageNet MobileNet checkpoint -> encoder npz tree (reference
    models.py:659-670 pretrained=True path)."""
    from fastdepth_tpu_torch.checkpoint.convert import (
        convert_imagenet_mobilenet,
        load_torch_checkpoint,
    )
    from fastdepth_tpu_torch.checkpoint.io import load_checkpoint

    if path.endswith(".npz"):
        params, _, _ = load_checkpoint(path)
        return params.get("encoder", params)
    sd, _, _, _ = load_torch_checkpoint(path)
    enc, _, _ = convert_imagenet_mobilenet(sd)
    return enc


def _check_args(args) -> None:
    """Every check the flags alone decide, SystemExit before any rank
    starts or anything loads (the JAX CLI's, and the card's presence)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    check_cli_mesh(args.mesh_devices, None, batch_size=args.batch_size)
    if args.mesh_devices and args.eval_batch_size % args.mesh_devices:
        raise SystemExit(
            f"--eval-batch-size {args.eval_batch_size} must divide by "
            f"--mesh-devices {args.mesh_devices}")
    if args.accum_steps < 1:
        raise SystemExit(f"--accum-steps must be >= 1, got {args.accum_steps}")
    if args.batch_size % args.accum_steps:
        raise SystemExit(
            f"--batch-size {args.batch_size} must divide by "
            f"--accum-steps {args.accum_steps} (equal microbatches)")
    if args.mesh_devices and (args.batch_size // args.accum_steps) % args.mesh_devices:
        raise SystemExit(
            f"microbatch size {args.batch_size // args.accum_steps} "
            f"(--batch-size / --accum-steps) must divide by "
            f"--mesh-devices {args.mesh_devices}: each device scans its "
            f"own microbatch rows")
    if args.resume and args.pretrained_encoder:
        raise SystemExit(
            "--resume and --pretrained-encoder conflict: resume restores "
            "the full checkpointed state, so the encoder load would be "
            "discarded. Drop one of the two flags.")
    if args.resume and args.arch_json:
        raise SystemExit(
            "--resume and --arch-json conflict: resume rebuilds the "
            "model from the checkpoint's own config, so the JSON "
            "architecture would be silently ignored. Drop one of the "
            "two flags.")


def main(argv=None):
    """Parse and check the flags, then train on every rank they ask for
    (``parallel.distributed.launch``); returns the best ``Result``."""
    args = parse_args(argv)
    _check_args(args)
    return D.launch(_main, args)


def _main(args):
    """One rank's run of the CLI (the whole run without a mesh)."""
    distributed = D.process_count() > 1
    D.validate_distributed_batches(
        distributed, args.mesh_devices,
        **{"--batch-size": args.batch_size, "--eval-batch-size": args.eval_batch_size})
    mesh = mesh_from_cli(args.mesh_devices, None, batch_size=args.batch_size)
    log = print if D.is_primary() else (lambda *a, **k: None)
    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are

    from fastdepth_tpu_torch.checkpoint import params_from_jax
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint
    from fastdepth_tpu_torch.data import NYUDataset
    from fastdepth_tpu_torch.models import build, from_name

    resume_tree = resume_meta = None
    if args.resume:
        log(f"=> resuming from '{args.resume}'")
        resume_tree, ckpt_cfg, resume_meta = load_train_checkpoint(args.resume)
        model = build(ckpt_cfg)
        params = model.load(params_from_jax(resume_tree["params"]))
    else:
        if args.arch_json:
            from fastdepth_tpu_torch.config import config_from_json

            model = build(config_from_json(args.arch_json))
        else:
            model = from_name(args.arch)
        # seeded init: every rank derives identical params
        params = model.init(torch.Generator().manual_seed(args.seed))
        if args.pretrained_encoder:
            log(f"=> loading pretrained encoder '{args.pretrained_encoder}'")
            enc = params_from_jax({"encoder": load_pretrained_encoder(args.pretrained_encoder)})
            unexpected = params.load_state_dict(enc, strict=False).unexpected_keys
            if unexpected:
                raise SystemExit(f"--pretrained-encoder: leaves the model lacks: {unexpected}")

    log("=> creating data loaders...")
    root = os.path.join(args.data_root, args.data)
    train_ds = NYUDataset(os.path.join(root, "train"), split="train", seed=args.seed,
                          device_augment=args.device_augment)
    val_ds = NYUDataset(os.path.join(root, "val"), split="val")
    # comparison strips stay off over several ranks: each holds only its
    # rows, so the strip's global image indices are not all on one rank
    return train_loop(args, model, params, train_ds, val_ds,
                      resume=(resume_tree, resume_meta) if resume_tree is not None else None,
                      log=log, make_images=not distributed, mesh=mesh)


@contextlib.contextmanager
def _tf32_as_found():
    """Validation runs in f32, which turns TF32 off (``engine.aot``); a bf16
    run gets the flags back as it found them."""
    found = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = found


def train_loop(args, model, params, train_ds, val_ds, resume=None, log=print,
               make_images=True, mesh=None):
    """The epoch loop of :func:`main` over two datasets: train, validate
    (``Evaluator`` + ``validate()``, the port's kernels on the card),
    track the best RMSE, write the CSVs and checkpoints.  ``resume`` is
    ``(tree, meta)`` from ``load_train_checkpoint``; ``make_images``
    writes validate()'s comparison PNGs (they need matplotlib).  The
    trainer augments on the device when ``train_ds`` emits device-augment
    items (``--device-augment``).  ``mesh``: a data mesh over the job's
    ranks; every rank calls this, each loads its rows of every batch, and
    only rank 0 writes files.  Returns the best ``Result`` (global: the
    same on every rank)."""
    from fastdepth_tpu_torch.checkpoint.io import save_checkpoint, save_train_checkpoint
    from fastdepth_tpu_torch.checkpoint import params_to_jax
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.data import BatchLoader
    from fastdepth_tpu_torch.engine import Evaluator, validate
    from fastdepth_tpu_torch.metrics import Result
    from fastdepth_tpu_torch.train import Trainer

    primary = D.is_primary()

    tc = TrainConfig(
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        epochs=args.epochs, batch_size=args.batch_size,
        lr_decay_step=args.lr_decay_step, lr_decay_gamma=args.lr_decay_gamma,
        seed=args.seed,
    )
    # each rank loads only its rows of every global batch (its share of
    # each microbatch under --accum-steps); the same seed gives every rank
    # the same shuffles
    train_loader = BatchLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                               num_workers=args.workers, drop_last=True, pad_last=False,
                               seed=args.seed, **D.shard_kwargs(args.accum_steps))
    val_loader = BatchLoader(val_ds, batch_size=args.eval_batch_size,
                             num_workers=args.workers, pad_last=True, **D.shard_kwargs())
    log(f"=> {len(train_ds)} train / {len(val_ds)} val images")

    trainer = Trainer(model, params, tc, mesh=mesh, remat=args.remat,
                      compute_dtype=torch.bfloat16 if args.bf16 else None,
                      accum_steps=args.accum_steps, device_augment=train_ds.device_augment,
                      device=None if mesh is not None else args.device)

    if primary:
        os.makedirs(args.output_dir, exist_ok=True)
    train_csv = os.path.join(args.output_dir, "train.csv")
    test_csv = os.path.join(args.output_dir, "test.csv")
    best = Result().set_to_worst()
    best_epoch = -1
    start_epoch = 0
    if resume is not None:
        tree, meta = resume
        trainer.restore(tree)  # momentum buffers + step counter
        start_epoch = meta["epoch"] + 1
        for k, v in meta.get("best_result", {}).items():
            setattr(best, k, v)
        best_epoch = meta.get("extra", {}).get("best_epoch", -1)
        log(f"=> resumed at epoch {start_epoch} "
            f"(best RMSE={best.rmse:.3f} @ epoch {best_epoch})")

    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        train_loader.set_epoch(epoch)  # resume-deterministic shuffles
        loss = trainer.run_epoch(train_loader, epoch, print_freq=args.print_freq, log=log)
        log(f"=> epoch {epoch}: train loss {loss:.4f} ({time.time() - t0:.1f}s)")
        if primary:
            with open(train_csv, "a", newline="") as f:
                w = csv.writer(f)
                if f.tell() == 0:
                    w.writerow(["epoch", "loss"])
                w.writerow([epoch, loss])

        with _tf32_as_found():
            evaluator = Evaluator(model, trainer.state.params, batch_size=args.eval_batch_size,
                                  mesh=mesh, device=None if mesh is not None else args.device)
            # every rank validates (the metric fetch is a collective); the
            # primary writes
            result = validate(val_loader, evaluator, epoch=epoch, print_freq=args.print_freq,
                              output_dir=args.output_dir if primary else None,
                              write_to_file=primary, csv_path=test_csv,
                              make_images=make_images, log=log)
        # best-epoch tracking by RMSE (reference main.py:20-24 semantics);
        # the result is global, so every rank tracks the same best
        if result.rmse < best.rmse:
            best = result
            best_epoch = epoch
            if primary:
                save_checkpoint(
                    os.path.join(args.output_dir, "model_best.npz"),
                    params_to_jax(trainer.state.params.state_dict()), model.config,
                    epoch=epoch, best_result={"rmse": best.rmse, "delta1": best.delta1,
                                              "mae": best.mae, "absrel": best.absrel},
                )
            log(f"=> new best (epoch {epoch}): RMSE={best.rmse:.3f}")
        # the resume file: full training state (momentum + step), plus the
        # best-so-far record so resume keeps best tracking intact
        if primary:
            save_train_checkpoint(
                os.path.join(args.output_dir, "checkpoint.npz"),
                trainer.state, model.config, epoch=epoch,
                best_result={"rmse": best.rmse, "delta1": best.delta1,
                             "mae": best.mae, "absrel": best.absrel}
                if best_epoch >= 0 else {},
                extra={"best_epoch": best_epoch},
            )
    log(f"=> done; best epoch {best_epoch}: RMSE={best.rmse:.3f} "
        f"Delta1={best.delta1:.3f}")
    return best


if __name__ == "__main__":
    main()
