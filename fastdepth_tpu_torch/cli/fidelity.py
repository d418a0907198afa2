"""f32 vs bf16 fidelity harness on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/fidelity.py`` (BASELINE.json config #3): evaluates a
checkpoint in both precisions over the same data and reports per-metric
deltas, so the bf16 serving path's accuracy cost is quantified rather
than assumed.

Usage:
    python -m fastdepth_tpu_torch.cli.fidelity --evaluate CKPT --data-root DIR
        [--batch-size 8] [--limit N] [--json OUT] [--device cuda|cpu]

:func:`compare` is the harness without the h5 loader: it takes any
loader factory (``chip_smoke.py`` feeds frames held in memory).
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="f32 vs bf16 fidelity check (PyTorch/CUDA port)")
    p.add_argument("--data", default="nyudepthv2", choices=["nyudepthv2"])
    p.add_argument("--data-root", default=os.path.join("..", "data"))
    p.add_argument("-e", "--evaluate", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N images (0 = all)")
    p.add_argument("--json", default=None,
                   help="also write the per-metric table to this JSON file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions; f32 is true f32 (TF32 off)")
    return p.parse_args(argv)


def compare(model, params, make_loader, *, batch_size: int, device="cuda"):
    """``validate()`` of the model in f32, then in bf16, each over a fresh
    ``make_loader()``; prints each run's headline and the per-metric table.
    Returns (``{"fp32": Result, "bf16": Result}``, the table
    ``{metric: {"fp32", "bf16", "abs_delta", "rel"}}``)."""
    from fastdepth_tpu_torch.engine import Evaluator, validate
    from fastdepth_tpu_torch.metrics import METRIC_FIELDS

    results = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ev = Evaluator(model, params, batch_size=batch_size, dtype=dtype, device=device)
        results[tag] = validate(make_loader(), ev, print_freq=0, make_images=False,
                                log=lambda *a: None)
        print(f"[{tag}] RMSE={results[tag].rmse:.3f} "
              f"Delta1={results[tag].delta1:.4f} REL={results[tag].absrel:.4f}")

    print("\nmetric       fp32         bf16         |delta|      rel")
    table = {}
    for f in METRIC_FIELDS:
        a = getattr(results["fp32"], f)
        b = getattr(results["bf16"], f)
        rel = abs(b - a) / abs(a) if a else 0.0
        table[f] = {"fp32": a, "bf16": b, "abs_delta": abs(b - a), "rel": rel}
        print(f"{f:<10}  {a:>11.5f}  {b:>11.5f}  {abs(b - a):>11.5f}  {rel:>8.2%}")
    return results, table


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")

    from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
    from fastdepth_tpu_torch.data import BatchLoader, NYUDataset

    params, model, _ = load_params_and_model(args.evaluate)
    dataset = NYUDataset(os.path.join(args.data_root, args.data, "val"), split="val")
    if args.limit:
        dataset = dataset.take(args.limit)

    results, table = compare(
        model, params,
        lambda: BatchLoader(dataset, batch_size=args.batch_size, num_workers=args.workers,
                            pad_last=True),
        batch_size=args.batch_size, device=args.device)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"checkpoint": args.evaluate, "images": len(dataset),
                       "batch_size": args.batch_size, "metrics": table},
                      fh, indent=1)
        print(f"=> wrote {args.json}")
    return results


if __name__ == "__main__":
    main()
