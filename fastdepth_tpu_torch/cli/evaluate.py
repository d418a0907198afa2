"""Evaluation CLI on the PyTorch/CUDA port — the ``main.py --evaluate``
equivalent (reference main.py:26-60, utils.py:12-34), counterpart of
``fastdepth_tpu/cli/evaluate.py``.

Usage:
    python -m fastdepth_tpu_torch.cli.evaluate --evaluate CKPT --data-root DIR [...]

CKPT is a native .npz checkpoint or a reference PyTorch .pth[.tar]
pickle, converted on load by the port's copy of the converter
(unpickling a full-module checkpoint executes code: pass TRUSTED .pth
files only).  Extras over the reference CLI: --batch-size, --bf16,
--no-fold-bn, --impl, --device-normalize, --device-preprocess, --no-images,
--split, --csv, --device, and the JAX CLI's mesh: ``--mesh-devices N``
evaluates over N ranks, one a device (``parallel/``), spawned here or one
a process under ``--coord``; each rank runs its rows of every batch, and
rank 0 prints and writes.  ``--mesh-spatial S`` also shards the image
height S-way (``N x S`` ranks; the MobileNet + NNConv family): each rank
runs its rows of every image through the height-sharded forward.
``--impl mixed --tuning tuning/h100.<model>.json`` runs each decoder level
on the kernel that won on the card (``engine/autotune.py``).
"""

from __future__ import annotations

import argparse
import os

import torch

from fastdepth_tpu_torch.data.nyu import OUTPUT_SIZE
from fastdepth_tpu_torch.engine.aot import IMPLS, check_tuning_flags, strict_f32
from fastdepth_tpu_torch.parallel import distributed as D
from fastdepth_tpu_torch.parallel.mesh import check_cli_mesh, mesh_from_cli


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth evaluation (PyTorch/CUDA port)")
    D.add_distributed_args(p)
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
    p.add_argument("--bf16", action="store_true",
                   help="run the model in bfloat16; without it f32 is true f32 (TF32 off "
                        "for cuDNN's convolutions and for matmuls)")
    p.add_argument("--mesh-devices", default=None, type=int,
                   help="shard batches over this many ranks, one a device (default: no "
                        "mesh; alone: spawned on this host; with --coord: N processes)")
    p.add_argument("--mesh-spatial", default=None, type=int, metavar="S",
                   help="additionally shard image HEIGHT S-way (total ranks = "
                        "mesh-devices x S; each rank exchanges its convs' halo rows "
                        "with its neighbours, parallel/spatial.py)")
    p.add_argument("--no-fold-bn", action="store_true",
                   help="keep BatchNorm unfolded (exact reference numerics)")
    p.add_argument("--tuning", default=None, metavar="JSON",
                   help="with --impl mixed: tuning record (tuning/*.json) "
                        "selecting each decoder stage's kernel")
    p.add_argument("--impl", default="auto", choices=IMPLS,
                   help="forward: auto = decoder levels through the fused CUDA "
                        "kernel when the architecture allows and BN is folded; mixed "
                        "= each level on its tuned winner (--tuning)")
    p.add_argument("--no-images", action="store_true", help="skip comparison PNGs")
    p.add_argument("--split", default="val", choices=["val", "holdout"],
                   help="dataset split (holdout = the two NetAdapt files, nyu.py:13-24)")
    p.add_argument("--device-normalize", action="store_true",
                   help="send uint8 RGB and /255 on the device (less host->device transfer)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="run the whole val resize/crop chain ON DEVICE as a "
                        "gather inside the step (raw 480x640 frames "
                        "ship to the card; host work drops to the h5 read; "
                        "identical values to the host pipeline)")
    p.add_argument("--csv", default=None, help="append final metrics to this CSV")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions; on either, f32 is true f32 (TF32 off)")
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
    """Parse and check the flags, then evaluate on every rank they ask for
    (``parallel.distributed.launch``); returns the ``Result``."""
    args = parse_args(argv)
    check_tuning_flags(args.impl, args.tuning)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    check_cli_mesh(args.mesh_devices, args.mesh_spatial, image_height=OUTPUT_SIZE[0],
                   batch_size=args.batch_size)
    if not os.path.isfile(args.evaluate):
        raise SystemExit(f"=> no model found at '{args.evaluate}'")
    return D.launch(_main, args)


def _main(args):
    """One rank's run of the CLI (the whole run without a mesh)."""
    distributed = D.process_count() > 1
    D.validate_distributed_batches(distributed, args.mesh_devices, args.mesh_spatial,
                                   **{"--batch-size": args.batch_size})
    # under --device-preprocess each rank's rows are raw frames, resized on
    # its device inside the step (under --mesh-spatial: whole raw frames,
    # each rank gathering its rows of the 224-row output)
    mesh = mesh_from_cli(args.mesh_devices, args.mesh_spatial, image_height=OUTPUT_SIZE[0],
                         batch_size=args.batch_size)
    primary = D.is_primary()
    log = print if primary else (lambda *a, **k: None)
    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are
    log(f"=> loading model '{args.evaluate}'")
    params, model, meta = load_params_and_model(args.evaluate)
    log(f"=> loaded model (epoch {meta.get('epoch', 0)})")

    from fastdepth_tpu_torch.data import BatchLoader, NYUDataset
    from fastdepth_tpu_torch.engine import Evaluator, validate

    log("=> creating data loaders...")
    valdir = os.path.join(args.data_root, args.data, "val")
    dataset = NYUDataset(valdir, split=args.split, modality=args.modality,
                         device_normalize=args.device_normalize,
                         raw_items=args.device_preprocess)
    loader = BatchLoader(dataset, batch_size=args.batch_size,
                         num_workers=args.workers, pad_last=True, **D.shard_kwargs(mesh=mesh))
    log("=> data loaders created.")

    evaluator = Evaluator(
        model, params,
        batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        fold_bn=not args.no_fold_bn,
        impl=args.impl,
        tuning=args.tuning,
        val_pipeline=dataset.val_pipeline if args.device_preprocess else None,
        mesh=mesh,
        device=None if mesh is not None else args.device,
    )
    # comparison strips stay off over several ranks: each holds only its
    # rows, so the strip's global image indices are not all on one rank
    return validate(
        loader, evaluator,
        epoch=meta.get("epoch", 0),
        print_freq=args.print_freq,
        output_dir=os.path.dirname(os.path.abspath(args.evaluate)) if primary else None,
        make_images=not args.no_images and not distributed,
        viz_transform=dataset.val_pipeline if args.device_preprocess else None,
        write_to_file=args.csv is not None and primary,
        csv_path=args.csv,
        log=log,
    )


if __name__ == "__main__":
    main()
