"""Per-layer time attribution + roofline for the FastDepth forward on the
card — counterpart of ``fastdepth_tpu/cli/profile.py``.

It attributes device time to the 20 points of the straight forward
(``model.apply``: stem, 13 encoder blocks, 5 decoder stages, head), two
ways, as the JAX tool does:

* ``--mode marginal`` (default): time the full forward, then a variant
  per point where THAT point runs twice, the second time on an
  eps-perturbed input blended back in by a runtime scalar (exact at
  eps=0).  Eager PyTorch neither merges nor drops the duplicate, but the
  method is kept so that the numbers mean what the JAX tool's mean: the
  difference is the point's marginal cost in context.
* ``--mode prefix``: time the forward truncated after point k for every
  k and difference consecutive prefixes.
* ``--trace DIR``: also a ``torch.profiler`` trace of the full forward
  (``engine/profiler.trace``).

Times are CUDA events around pipelined calls (``engine/benchmark.py``);
on ``--device cpu`` they are CPU times of the same code, and the JSON
says so.  Each point gets a roofline bound (``engine/roofline.py``: the
JAX module's formulas on the H100's measured ceilings,
``docs/probe_h100_hbm.json``), so "measured vs bound" says which layers
leave the card idle.  Parameters are random (``Model.init`` with a seeded
``torch.Generator``), BN-folded, in the run's dtype.

Usage:
    python -m fastdepth_tpu_torch.cli.profile [--batch 128] [--bf16] [--mode prefix]
        [--json OUT] [--trace DIR] [--model pruned|unpruned] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fastdepth_tpu_torch.config import MOBILENET_STRIDES
from fastdepth_tpu_torch.engine import roofline as RL
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.models.fastdepth import SKIP_AFTER, SKIP_TAPS
from fastdepth_tpu_torch.ops import blocks as B


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-layer profile + roofline (PyTorch/CUDA port)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--json", default=None, help="write the table to this JSON file")
    p.add_argument("--mode", default="marginal", choices=["marginal", "prefix"])
    p.add_argument("--trace", default=None, help="also write a torch.profiler trace here")
    p.add_argument("--model", default="pruned", choices=["pruned", "unpruned"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda times the card; cpu runs the same code on the CPU (CPU times)")
    p.add_argument("--ceilings", default=None,
                   help=f"calibration JSON with the ceilings (default {RL.CEILINGS_PATH})")
    return p.parse_args(argv)


def prefix_points(cfg):
    """(label, kind) per attribution point: encoder stem + 13 blocks,
    5 decoder stages (conv+upsample+skip), final head."""
    pts = [("enc.conv0", "stem")]
    pts += [(f"enc.conv{i}", "enc_block") for i in range(1, 14)]
    pts += [(f"dec.stage{i}", "dec_stage") for i in range(1, 6)]
    pts += [("dec.head", "head")]
    return pts


def _points(params, cfg) -> List[Tuple[Callable, Optional[int]]]:
    """The forward as 20 ``(f, tap)`` pairs, one per attribution point:
    ``f(y, tapped) -> y`` on channels_last NCHW (decoder stages read the
    encoder's skip taps from ``tapped``); ``tap`` names the encoder block
    whose output the caller keeps as a skip tap."""
    act = B.relu6 if cfg.encoder_relu6 else B.relu
    enc, dec = params["encoder"], params["decoder"]
    pts = [(lambda y, tapped: L.apply_conv_bn(y, enc["conv0"], stride=2, act=act), None)]
    for i in range(1, 14):
        def block(y, tapped, p=enc[f"conv{i}"], s=MOBILENET_STRIDES[i - 1]):
            y = L.apply_conv_bn(y, p["dw"], stride=s, act=act, depthwise=True)
            return L.apply_conv_bn(y, p["pw"], act=act)
        pts.append((block, i if i in SKIP_TAPS else None))
    skips = SKIP_AFTER if cfg.skip == "add" else {}
    for i in range(1, 6):
        def stage(y, tapped, p=dec[f"decode_conv{i}"], i=i):
            y = L.apply_conv_bn(y, p["dw"], depthwise=True)
            y = B.upsample_nearest2x(L.apply_conv_bn(y, p["pw"]))
            return y + tapped[skips[i]] if i in skips else y
        pts.append((stage, None))
    pts.append((lambda y, tapped: L.apply_conv_bn(y, dec["decode_conv6"]["pw"]), None))
    return pts


def make_prefix_fn(model, cfg, upto: int):
    """Forward truncated after attribution point ``upto`` (1-based count
    of prefix_points), reduced to an f32 scalar."""
    def fn(params, x):
        y, tapped = B.from_nhwc(x), {}
        for f, tap in _points(params, cfg)[:upto]:
            y = f(y, tapped)
            if tap is not None:
                tapped[tap] = y
        return torch.sum(y, dtype=torch.float32)
    return fn


def make_marginal_fn(model, cfg, dup: Optional[int]):
    """Full forward with attribution point ``dup`` (1-based, or None) run
    twice, the second time on an eps-perturbed input blended back by the
    runtime scalar ``eps`` (exact at eps=0)."""
    def fn(params, x, eps):
        y, tapped = B.from_nhwc(x), {}
        for n, (f, tap) in enumerate(_points(params, cfg), start=1):
            out = f(y, tapped)
            if dup == n:
                out = out + eps.to(out.dtype) * (f(y * (1 + eps.to(y.dtype)), tapped) - out)
            y = out
            if tap is not None:
                tapped[tap] = y
        return torch.sum(y, dtype=torch.float32)
    return fn


def layer_roofline(cfg, batch: int, hw: int, dtype_bytes: int, ceilings: RL.Ceilings):
    """Per-attribution-point (name, macs, hbm_bytes, bound_s) on the
    card's ceilings (formulas shared with the JAX module)."""
    return [(key, batch * macs, batch * hbm_e * dtype_bytes,
             RL.bound_seconds(hbm_e, mxu, dw, dtype_bytes, ceilings, batch))
            for key, macs, hbm_e, mxu, dw in RL.layer_bounds(cfg, hw)]


def _model(name: str):
    from fastdepth_tpu_torch.models.registry import fastdepth_pruned, fastdepth_unpruned

    return fastdepth_pruned() if name == "pruned" else fastdepth_unpruned()


def main(argv=None) -> Dict:
    args = parse_args(argv)
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    device = torch.device(args.device)
    dev_info = {"type": device.type}
    if device.type == "cuda":
        from fastdepth_tpu_torch.engine.aot import strict_f32
        from fastdepth_tpu_torch.engine.benchmark import card_info

        dev_info.update(card_info())  # raises without a card
        print(dev_info["nvidia_smi"])
        strict_f32()  # f32 is true f32, as the f32 ceilings
    model = _model(args.model)
    cfg = model.config
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    dtype_bytes = 2 if args.bf16 else 4
    params = model.fold(model.init(torch.Generator().manual_seed(0)))
    params = params.to(device=device, dtype=dtype)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(args.batch, args.image_size, args.image_size, 3)
                         .astype(np.float32)).to(device, dtype)
    ceilings = RL.load_ceilings(dtype_bytes, args.ceilings)
    pts = prefix_points(cfg)
    roof = layer_roofline(cfg, args.batch, args.image_size, dtype_bytes, ceilings)
    unit = "us" if device.type == "cuda" else "cpu us"

    def timed(fn, fargs, warmup=3):
        with torch.inference_mode():
            return time_pipelined(fn, fargs, warmup=warmup, calls=args.calls,
                                  device=device)["mean_s"]

    def full(p, a):
        return torch.sum(model.apply(p, a), dtype=torch.float32)

    t_full = timed(full, (params, x))
    print(f"full forward: {t_full * 1e6:.0f} {unit}/call, {args.batch / t_full:.0f} fps "
          f"(b{args.batch}, {'bf16' if args.bf16 else 'fp32'}, {device.type})")

    if args.trace:
        from fastdepth_tpu_torch.engine.profiler import trace

        with torch.inference_mode(), trace(args.trace):
            for _ in range(3):
                out = full(params, x)
            float(out)
        print(f"trace written to {args.trace}")

    deltas = []
    if args.mode == "marginal":
        eps = torch.tensor(1e-6, dtype=torch.float32, device=device)
        t_base = timed(make_marginal_fn(model, cfg, None), (params, x, eps))
        print(f"  marginal base: {t_base * 1e6:8.1f} {unit}")
        for k in range(1, len(pts) + 1):
            t = timed(make_marginal_fn(model, cfg, k), (params, x, eps), warmup=2)
            deltas.append(t - t_base)
            print(f"  marginal {k:2d} ({pts[k - 1][0]:<12}): +{(t - t_base) * 1e6:8.1f} {unit}")
    else:
        prev = 0.0
        for k in range(1, len(pts) + 1):
            t = timed(make_prefix_fn(model, cfg, k), (params, x), warmup=2)
            deltas.append(t - prev)
            prev = t
            print(f"  prefix {k:2d} ({pts[k - 1][0]:<12}): cum {t * 1e6:8.1f} {unit}")

    table = []
    print(f"\n{'layer':<12} {'meas ' + unit:>10} {'bound us':>9} {'x-bound':>8} "
          f"{'MACs(M)':>9} {'MB':>7}")
    for (name, _kind), dt, (_rname, macs, byts, bound) in zip(pts, deltas, roof):
        ratio = dt / bound if bound > 0 else float("inf")
        table.append({"layer": name, "measured_us": dt * 1e6, "bound_us": bound * 1e6,
                      "x_bound": ratio, "macs": macs, "hbm_bytes": byts})
        print(f"{name:<12} {dt * 1e6:>10.1f} {bound * 1e6:>9.1f} {ratio:>8.2f} "
              f"{macs / 1e6:>9.1f} {byts / 1e6:>7.2f}")
    total_bound = sum(r[3] for r in roof)
    print(f"\nsum of bounds: {total_bound * 1e6:.0f} us; measured full: {t_full * 1e6:.0f} "
          f"{unit}; layer-sum: {sum(deltas) * 1e6:.0f} {unit}; bounds within the full "
          f"forward: {'yes' if total_bound <= t_full else 'NO'}")
    payload = {
        "batch": args.batch, "dtype": "bf16" if args.bf16 else "fp32", "model": args.model,
        "mode": args.mode, "device": dev_info, "full_us": t_full * 1e6,
        "fps": args.batch / t_full, "sum_bounds_us": total_bound * 1e6,
        "layer_sum_us": sum(deltas) * 1e6, "layers": table,
        "peaks": {"hbm_bps": ceilings.hbm_bps, "pointwise_macs": ceilings.pointwise_macs,
                  "depthwise_macs": ceilings.depthwise_macs, "card": ceilings.card},
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"json -> {args.json}")
    return payload


if __name__ == "__main__":
    main()
