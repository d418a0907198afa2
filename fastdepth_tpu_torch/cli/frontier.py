"""Throughput-frontier sweep on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/frontier.py``, the analogue of the reference's
accuracy-vs-fps plots (reference img/acc_fps_{gpu,cpu}.png,
README.md:140-143).

Sweeps the model zoo x dtype x batch on the attached card and writes a
JSON + markdown table of frames/s per configuration, with the JAX
package's row keys.  Accuracy columns carry the published values where
the reference publishes them (README.md:136 — the pruned flagship row);
measuring the rest needs the real checkpoints + NYU val set
(docs/parity_runbook.md) — the table marks them pending.

    python -m fastdepth_tpu_torch.cli.frontier [--out docs/frontier_h100] [--device cuda|cpu]

The impls are 'xla' (the straight folded forward), 'opt' (the
head-commute forward) where it applies, and, on a card, 'mixed' for the
K1 family when ``tuning/<tag>.<model>.json`` exists for this card
(``engine/autotune.device_tag``: ``h100`` on an H100).  ``--device cpu``
times the plain versions on the CPU (CPU times, for the table's shape).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TX2_GPU_FPS = 178.6  # the reference's TX2 GPU row (BASELINE.md: 5.6 ms a frame)

# (zoo name, config factory key, published RMSE m / delta1 if any)
SWEEP_MODELS = [
    ("mobilenet-nnconv5dw-skipadd-pruned", "pruned", 0.604, 0.771),
    ("mobilenet-nnconv5dw-skipadd", "unpruned", None, None),
    ("mobilenet-nnconv5dw", "nnconv5dw", None, None),
    ("mobilenet-nnconv5", "nnconv5", None, None),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="throughput frontier sweep (PyTorch/CUDA port)")
    p.add_argument("--out", default=os.path.join("docs", "frontier_h100"),
                   help="output stem: writes <out>.json and <out>.md")
    p.add_argument("--batches", default="1,32,128,256")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--models", default="all")
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--budget-s", type=float, default=3000.0,
                   help="stop adding configs past this wall-clock budget")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda times the card; cpu the plain versions on the CPU")
    return p.parse_args(argv)


def _build(key):
    from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED, FASTDEPTH_UNPRUNED, ModelConfig
    from fastdepth_tpu_torch.models import build

    cfg = {
        "pruned": FASTDEPTH_PRUNED,
        "unpruned": FASTDEPTH_UNPRUNED,
        "nnconv5dw": ModelConfig(decoder="nnconv5dw", skip=None),
        "nnconv5": ModelConfig(decoder="nnconv5", skip=None),
    }[key]
    return build(cfg)


def macs_g(model) -> float:
    """Analytic multiply-accumulates per frame at 224x224 (the README
    table's 'MACs [G]' column, reference README.md:136)."""
    from fastdepth_tpu_torch.config import MOBILENET_STRIDES

    cfg = model.config
    enc = cfg.encoder_channels
    total = 112 * 112 * enc[0] * 9 * cfg.in_channels  # stem
    h, cin = 112, enc[0]
    for i in range(1, 14):
        s = MOBILENET_STRIDES[i - 1]
        h_out = h // s
        total += h_out * h_out * cin * 9          # dw3x3
        total += h_out * h_out * cin * enc[i]     # pw
        h, cin = h_out, enc[i]
    k = cfg.decoder_kernel
    for cout in cfg.decoder_channels:
        if cfg.decoder_depthwise:
            total += h * h * cin * k * k + h * h * cin * cout
        else:
            total += h * h * k * k * cin * cout
        h, cin = h * 2, cout
    total += h * h * cin  # 1x1 head
    return total / 1e9


def tuning_path(name: str, device="cuda") -> str:
    """The committed tuning record of model ``name`` for this card."""
    from fastdepth_tpu_torch.engine.autotune import _device_kind, device_tag

    return os.path.join(REPO, "tuning", f"{device_tag(_device_kind(device))}.{name}.json")


def _impls(name: str, model, device) -> list:
    """(impl, tuning) pairs the sweep times for ``model``: 'xla', 'opt'
    where it applies, and 'mixed' on a card for the K1 family when this
    card's record exists (K1's plain versions on the CPU would time a
    garbage row, as Pallas' interpreter would in the JAX package)."""
    from fastdepth_tpu_torch.models.fused import supports_fused, supports_opt

    impls = [("xla", None)]
    if supports_opt(model.config):
        impls.append(("opt", None))
    path = tuning_path(name, device)
    if (torch.device(device).type == "cuda" and supports_fused(model.config)
            and os.path.exists(path)):
        impls.append(("mixed", path))
    return impls


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.engine.benchmark import card_info, time_pipelined

    batches = [int(b) for b in args.batches.split(",")]
    dtypes = [d.strip() for d in args.dtypes.split(",")]
    for d in dtypes:
        if not isinstance(getattr(torch, d, None), torch.dtype):
            raise SystemExit(f"unknown dtype {d!r} (e.g. bfloat16, float32)")
    wanted = (None if args.models == "all"
              else {m.strip() for m in args.models.split(",")})
    if wanted is not None:
        known = {name for name, *_ in SWEEP_MODELS}
        unknown = wanted - known
        if unknown:
            raise SystemExit(
                f"unknown model(s) {sorted(unknown)}; valid: {sorted(known)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to time the plain PyTorch versions)")
    card = card_info() if device.type == "cuda" else None

    rng = np.random.RandomState(0)
    t_start = time.time()
    rows = []
    over_budget = False
    for name, key, rmse, d1 in SWEEP_MODELS:
        if over_budget or (wanted is not None and name not in wanted):
            continue
        model = _build(key)
        init = model.init(torch.Generator().manual_seed(0))
        impls = _impls(name, model, device)
        for dtype_name in dtypes:
            if over_budget:
                break
            dtype = getattr(torch, dtype_name)
            forwards = {}
            for impl, tuning in impls:
                params, apply = _prepare(model, init, batch_size=max(batches), dtype=dtype,
                                         fold_bn=True, impl=impl, device=device, tuning=tuning)
                forwards[impl] = (lambda x, p=params, f=apply: f(p, x))
            for b in batches:
                if over_budget:
                    break
                for impl_name, fwd in forwards.items():
                    if time.time() - t_start > args.budget_s and rows:
                        if not over_budget:
                            print("! budget hit, skipping the rest of the "
                                  "sweep", flush=True)
                        over_budget = True
                    if over_budget:
                        break
                    x = torch.from_numpy(rng.rand(b, 224, 224, 3)).to(device=device,
                                                                      dtype=dtype)
                    t0 = time.time()
                    with torch.inference_mode():
                        stats = time_pipelined(fwd, (x,), warmup=3, calls=args.calls,
                                               device=device)
                    fps = b / stats["mean_s"]
                    rows.append({
                        "model": name, "dtype": dtype_name, "batch": b,
                        "impl": impl_name,
                        "fps": round(fps, 1),
                        "us_per_frame": round(1e6 / fps, 2),
                        "macs_g": round(macs_g(model), 3),
                        "rmse_m_published": rmse, "delta1_published": d1,
                    })
                    print(f"{name} {dtype_name} b{b} {impl_name}: {fps:.0f} fps "
                          f"({time.time()-t0:.0f}s)", flush=True)

    kind = card["name"] if card else device.type
    out = {"device": kind, "image": "224x224", "rows": rows,
           "baseline_tx2_gpu_fps": TX2_GPU_FPS}
    if card:
        out["nvidia_smi"] = card["nvidia_smi"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)

    where = card["nvidia_smi"] if card else "the CPU (plain versions; CPU times)"
    lines = [
        "# Throughput frontier (one card, 224x224)",
        "",
        f"Device: {where}, `python -m fastdepth_tpu_torch.cli.frontier`.  Random "
        "weights, frames/s of back-to-back forwards (`engine/benchmark.time_pipelined`).  "
        "The reference's equivalent artifact is the "
        "acc-vs-fps plot pair (reference img/acc_fps_*.png, "
        "README.md:140-143); accuracy columns are published values "
        "(README.md:136) — 'pending' rows need the released checkpoints + "
        "NYU val set (docs/parity_runbook.md).",
        "",
        "| model | dtype | batch | impl | fps | us/frame | MACs [G] | RMSE [m] | delta1 "
        "| vs TX2-GPU |",
        "|---|---|---:|---|---:|---:|---:|---:|---:|---:|",
    ]
    for r in rows:
        lines.append(
            f"| {r['model']} | {r['dtype']} | {r['batch']} | {r['impl']} "
            f"| {r['fps']:.0f} "
            f"| {r['us_per_frame']:.1f} | {r['macs_g']:.2f} "
            f"| {r['rmse_m_published'] if r['rmse_m_published'] else 'pending'} "
            f"| {r['delta1_published'] if r['delta1_published'] else 'pending'} "
            f"| {r['fps'] / TX2_GPU_FPS:.1f}x |"
        )
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}.json and {args.out}.md ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
