"""Accuracy-parity readiness harness on the PyTorch/CUDA port (one
command) — counterpart of ``fastdepth_tpu/cli/parity.py``.

The published ground truth is the reference README results table
(reference README.md:136: RMSE 0.604 m / delta1 0.771 for
mobilenet-nnconv5dw-skipadd-pruned on NYU Depth v2 val) and the frozen
golden prediction ``deploy/data/pred.npy`` (reference
deploy/tx2_run_tvm.py:35-40).  Those claims need two artifacts that are
not redistributable with this repo: the NYU val set and a released
``.pth.tar`` checkpoint.  This harness makes the parity claim checkable
the moment the artifacts exist:

    python -m fastdepth_tpu_torch.cli.parity \\
        --evaluate results/mobilenet-nnconv5dw-skipadd-pruned.pth.tar \\
        --data-root ../data [--golden-dir <reference>/deploy/data] [--device cuda|cpu]

does, in order:

1. convert/load the checkpoint (torch pickle through the port's
   ``checkpoint/convert.py``, or native .npz),
2. evaluate f32 batch-1 over the full val split,
3. assert RMSE and delta1 within --tolerance (default 1e-3) of the
   published row (overridable via --expected-rmse/--expected-delta1),
4. regress the model's output on the reference's own golden input
   ``rgb.npy`` against ``pred.npy`` (max-abs-diff report + threshold),
5. report f32->bf16 per-metric deltas on the same data (the fidelity
   cost of the bf16 serving path, BASELINE config #3).

Exit code 0 = full parity; 2 = artifacts missing (loud skip);
1 = parity FAILED.  Runbook: docs/parity_runbook.md.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

# Published row for the flagship checkpoint (reference README.md:136).
# RMSE is in meters there; the framework's metrics are in millimeters
# (reference metrics.py:34-35), converted at the comparison site.
PUBLISHED = {
    "mobilenet-nnconv5dw-skipadd-pruned": {"rmse_m": 0.604, "delta1": 0.771},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth parity harness (PyTorch/CUDA port)")
    p.add_argument("-e", "--evaluate", required=True,
                   help="released .pth[.tar] (TRUSTED source only — full-module "
                        "pickle) or native .npz checkpoint")
    p.add_argument("--data-root", default=os.path.join("..", "data"))
    p.add_argument("--data", default="nyudepthv2", choices=["nyudepthv2"])
    p.add_argument("--golden-dir", default=None,
                   help="directory holding the reference's deploy/data "
                        "{rgb,pred}.npy golden pair (step 4; skipped if absent)")
    p.add_argument("--expected-rmse", type=float, default=None,
                   help="published RMSE in meters (default: inferred from the "
                        "checkpoint filename via the README table)")
    p.add_argument("--expected-delta1", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="max |measured - published| for RMSE [m] and delta1")
    p.add_argument("--golden-prenormalized", default="auto",
                   choices=["auto", "yes", "no"],
                   help="is rgb.npy already in [0,1]? 'auto' infers from "
                        "dtype/range (uint8 or max>2 -> raw, /255 applied) "
                        "and prints the decision; override for ambiguous "
                        "float inputs (e.g. a raw [0,255] float frame of a "
                        "dark scene)")
    p.add_argument("--golden-atol", type=float, default=1e-2,
                   help="max-abs-diff [m] allowed vs pred.npy (the golden was "
                        "produced by the TVM fp32 build; bit-identity across "
                        "compilers is not expected)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="fp32 batch-1 is the published protocol (main.py:40)")
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--skip-bf16", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions; f32 is true f32 (TF32 off)")
    return p.parse_args(argv)


def normalize_golden_rgb(rgb, mode: str = "auto", log=None):
    """Golden rgb.npy -> model-ready [0,1] float array.

    The reference's deploy/data/rgb.npy is ALREADY normalized — float in
    [0,1], fed with no /255 by tx2_run_tvm.py:28-33 — so it must NOT be
    divided again; raw uint8-range inputs are rescaled.  ``mode``:
    'yes' = input is pre-normalized, 'no' = raw [0,255], 'auto' = infer
    from dtype/range (uint8 or max>2 -> raw) and report the decision —
    the one ambiguous case is a raw float frame so dark that max<=2."""
    import numpy as np

    x = np.asarray(rgb, np.float32)
    if mode == "auto":
        raw = np.asarray(rgb).dtype == np.uint8 or float(x.max()) > 2.0
        if log is not None:
            log(f"golden rgb.npy treated as "
                f"{'raw [0,255] (/255 applied)' if raw else 'pre-normalized [0,1]'}"
                f" — override with --golden-prenormalized if wrong")
    else:
        raw = mode == "no"
    return x / 255.0 if raw else x


def _expected_for(path: str, args):
    if args.expected_rmse is not None and args.expected_delta1 is not None:
        return {"rmse_m": args.expected_rmse, "delta1": args.expected_delta1}
    name = os.path.basename(path)
    for key, row in PUBLISHED.items():
        if key in name:
            return dict(row)
    return None


def main(argv=None) -> int:
    args = parse_args(argv)

    # ---- artifact availability gate (loud skip, exit 2) ----
    valdir = os.path.join(args.data_root, args.data, "val")
    missing = []
    if not os.path.isfile(args.evaluate):
        missing.append(f"checkpoint: {args.evaluate}")
    if not os.path.isdir(valdir):
        missing.append(f"NYU val split: {valdir}")
    if missing:
        print("PARITY SKIPPED — required artifacts are not present:")
        for m in missing:
            print(f"  - {m}")
        print("Download instructions: docs/parity_runbook.md "
              "(reference README.md:43-57).")
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")

    expected = _expected_for(args.evaluate, args)

    import numpy as np

    from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
    from fastdepth_tpu_torch.data import BatchLoader, NYUDataset
    from fastdepth_tpu_torch.engine import Evaluator, validate
    from fastdepth_tpu_torch.engine.aot import compile_forward
    from fastdepth_tpu_torch.metrics import METRIC_FIELDS

    print(f"=> loading '{args.evaluate}'")
    params, model, _ = load_params_and_model(args.evaluate)
    dataset = NYUDataset(valdir, split="val")

    failures = []

    # ---- step 2: f32 full-val evaluation (published protocol) ----
    loader = BatchLoader(dataset, batch_size=args.batch_size,
                         num_workers=args.workers, pad_last=True)
    ev32 = Evaluator(model, params, batch_size=args.batch_size, dtype=torch.float32,
                     device=args.device)
    res32 = validate(loader, ev32, print_freq=200, make_images=False)
    rmse_m = res32.rmse / 1000.0  # framework metrics are mm; table is m

    # ---- step 3: assert vs the published row ----
    if expected is None:
        print("! no published row matches this checkpoint name and no "
              "--expected-rmse/--expected-delta1 given; skipping the table "
              "assertion (measured numbers above).")
    else:
        d_rmse = abs(rmse_m - expected["rmse_m"])
        d_d1 = abs(res32.delta1 - expected["delta1"])
        ok = d_rmse <= args.tolerance and d_d1 <= args.tolerance
        print(f"table parity: RMSE {rmse_m:.4f} vs {expected['rmse_m']:.3f} "
              f"(|d|={d_rmse:.4f}), delta1 {res32.delta1:.4f} vs "
              f"{expected['delta1']:.3f} (|d|={d_d1:.4f}) "
              f"[tol {args.tolerance}] -> {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append("published-table parity")

    # ---- step 4: golden regression vs deploy/data/pred.npy ----
    golden_dir = args.golden_dir
    if golden_dir and os.path.isfile(os.path.join(golden_dir, "rgb.npy")) \
            and os.path.isfile(os.path.join(golden_dir, "pred.npy")):
        rgb = np.load(os.path.join(golden_dir, "rgb.npy"))  # HWC
        pred_ref = np.load(os.path.join(golden_dir, "pred.npy"))  # 1,1,H,W
        x = normalize_golden_rgb(rgb, mode=args.golden_prenormalized, log=print)[None]
        forward, prepared = compile_forward(model, params, batch_size=1,
                                            image_size=x.shape[1:3], impl="xla",
                                            device=args.device)
        out = forward(prepared, torch.from_numpy(x).to(args.device)).cpu().numpy()  # N,H,W,1
        out_nchw = np.transpose(out, (0, 3, 1, 2))
        diff = np.abs(out_nchw - pred_ref.reshape(out_nchw.shape))
        print(f"golden pred.npy regression: max|d|={diff.max():.5f} m, "
              f"mean|d|={diff.mean():.5f} m [atol {args.golden_atol}] -> "
              f"{'OK' if diff.max() <= args.golden_atol else 'FAIL'}")
        if diff.max() > args.golden_atol:
            failures.append("golden pred.npy regression")
    else:
        print("! golden dir not given/found — skipping pred.npy regression "
              "(pass --golden-dir <reference>/deploy/data).")

    # ---- step 5: bf16 fidelity cost on the same data ----
    if not args.skip_bf16:
        loader = BatchLoader(dataset, batch_size=max(args.batch_size, 8),
                             num_workers=args.workers, pad_last=True)
        ev16 = Evaluator(model, params, batch_size=max(args.batch_size, 8),
                         dtype=torch.bfloat16, device=args.device)
        res16 = validate(loader, ev16, print_freq=0, make_images=False,
                         log=lambda *a: None)
        print("\nbf16 fidelity (fp32 -> bf16):")
        print("metric       fp32         bf16         |delta|")
        for f in METRIC_FIELDS:
            a, b = getattr(res32, f), getattr(res16, f)
            print(f"{f:<10}  {a:>11.5f}  {b:>11.5f}  {abs(b - a):>11.5f}")

    if failures:
        print(f"\nPARITY FAILED: {', '.join(failures)}")
        return 1
    print("\nPARITY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
