"""Measure the card's ceilings — counterpart of ``scripts/calibrate_hbm.py``.

The same rows under the same names, on the card:

1. flat streaming: K passes of ``x * c`` over 256 MB (bf16, f32) and
   64 MB (bf16) arrays; each pass reads and writes the array once;
2. the decoder's activation shapes at batch 128 (bf16): the same
   multiply, and the skip-add pattern ``x + y`` with a keep-alive ``y * c``
   (5 moves per iteration);
3. the decoder's depthwise 5x5 (+ bias, ReLU) chains at the dec3/dec4/
   dec5 geometries and a 56 -> 56 pointwise conv at 112^2 (bf16, cuDNN);
4. an 8192^3 matmul chain in bf16 and in f32 with TF32 off;
5. K5's copy sweep (``engine/probes.copy_sweep``) at 32 MB and 256 MB.

The JAX script chained its passes in one jit with optimization barriers
so that XLA could not fuse them; eager PyTorch runs every pass as its own
kernel, so a chain is a Python loop.  Per-pass time is CUDA-event time
over ``calls`` back-to-back chains of K passes, divided by ``calls * K``.
Inputs are made on the card from a seeded ``torch.Generator``.

Sizes below ~50 MB of traffic partly read the 50 MB L2; each row keeps
the script's size, and only the 256 MB rows set the device memory's
ceiling, which may not exceed the data sheet's 3.35 TB/s (a higher
reading would be L2: the run fails).  The rate that no row measures (the
CUDA cores' f32 FMA rate, for the depthwise work of the roofline) is the
H100 SXM data sheet's, named as such.

Usage (on a card; writes the JSON that ``engine/roofline.py`` reads):
    python -m fastdepth_tpu_torch.engine.calibrate [--calls 30] \\
        [--out docs/probe_h100_hbm.json]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

import torch

from fastdepth_tpu_torch.engine import probes as P
from fastdepth_tpu_torch.engine.benchmark import card_info, time_pipelined
from fastdepth_tpu_torch.ops import blocks as B

K = 16  # passes per chain, as the script
CALLS = 30
MM_N = 8192
MM_PASSES = 4
# NVIDIA H100 SXM data sheet (dense rates, at the 700 W power limit)
DATA_SHEET = {"source": "NVIDIA H100 SXM data sheet, dense, 700 W", "hbm_GBs": 3350.0,
              "bf16_tensor_tflops": 989.0, "tf32_tensor_tflops": 495.0, "f32_tflops": 67.0}

FLAT = [("flat mul bf16 256MB", torch.bfloat16, 1 << 27),
        ("flat mul f32 256MB", torch.float32, 1 << 26),
        ("flat mul bf16 64MB", torch.bfloat16, 1 << 25)]
SHAPES = {"dec4_in (128,56,56,120)": (128, 56, 56, 120),
          "dec4_out (128,112,112,56)": (128, 112, 112, 56),
          "dec5_out (128,224,224,16)": (128, 224, 224, 16)}
DW = [("dec4 dw5x5 120ch@56^2", (128, 56, 56, 120)),
      ("dec5 dw5x5 56ch@112^2", (128, 112, 112, 56)),
      ("dec3 dw5x5 256ch@28^2", (128, 28, 28, 256))]


def mul_chain(x, c):
    for _ in range(K):
        x = x * c
    return x


def add_chain(x, y, c):
    for _ in range(K):
        x = x + y
        y = y * c  # keeps both live; the second pass is counted
    return x, y


def dw_chain(x, w, b):
    for _ in range(K):
        x = B.relu(B.depthwise_conv2d(x, w, bias=b))
    return x


def pw_chain(x, w, b):
    for _ in range(K):
        x = B.relu(B.conv2d(x, w, bias=b))
    return x


def mm_chain(x, w):
    for _ in range(MM_PASSES):
        x = x @ w
    return x


class _Bench:
    def __init__(self, device: torch.device, calls: int, log: Callable[[str], None]):
        self.device, self.calls, self.log = device, calls, log
        self.gen = torch.Generator(device=device).manual_seed(0)
        self.rows: List[dict] = []

    def rand(self, shape, dtype, scale=1.0):
        return (torch.rand(shape, generator=self.gen, device=self.device) * scale).to(dtype)

    def __call__(self, name, fn, args, bytes_per_pass, k=K) -> dict:
        with torch.inference_mode():
            mean_s = time_pipelined(fn, args, warmup=1, calls=self.calls,
                                    device=self.device)["mean_s"]
        per_pass_s = mean_s / k
        gbs = bytes_per_pass / per_pass_s / 1e9
        row = {"name": name, "per_pass_us": per_pass_s * 1e6, "GBs": gbs,
               "pct_data_sheet": 100 * gbs / DATA_SHEET["hbm_GBs"],
               "bytes_per_pass": bytes_per_pass}
        self.rows.append(row)
        self.log(f"{name:42s} {row['per_pass_us']:>10.2f} us/pass  {gbs:>8.1f} GB/s  "
                 f"({row['pct_data_sheet']:5.1f}% of the data sheet)")
        return row


def calibrate(device="cuda", calls: int = CALLS, log: Callable[[str], None] = print) -> Dict:
    """Run every row on the card; returns the JSON payload (rows, matmul
    rates, copy sweep, ceilings, card).  Raises without a card, and when
    a 256 MB row reads above the data sheet's device-memory rate."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("calibration measures the card: it needs a CUDA device")
    card = card_info()
    bench = _Bench(device, calls, log)
    c = {dt: torch.tensor(1.0009, dtype=dt, device=device)
         for dt in (torch.bfloat16, torch.float32)}
    bf16 = torch.bfloat16

    # 1. flat streaming ceilings
    for name, dtype, n in FLAT:
        x = bench.rand((n,), dtype)
        bench(name, mul_chain, (x, c[dtype]), 2 * n * x.element_size())
        del x
    # 2. activation-shaped streams, and the skip-add pattern (5 moves)
    for name, shape in SHAPES.items():
        x = bench.rand(shape, bf16)
        bench(f"mul {name}", mul_chain, (x, c[bf16]), 2 * x.numel() * 2)
        del x
    x, y = bench.rand(SHAPES["dec4_out (128,112,112,56)"], bf16), \
        bench.rand(SHAPES["dec4_out (128,112,112,56)"], bf16)
    bench("add+mul dec4_out (5 moves)", add_chain, (x, y, c[bf16]), 5 * x.numel() * 2)
    del x, y
    # 3. depthwise 5x5 chains and a square pointwise conv (channels_last)
    for name, (n, h, w, ch) in DW:
        x = B.from_nhwc(bench.rand((n, h, w, ch), bf16))
        wt = bench.rand((ch, 1, 5, 5), bf16, 0.1)
        b = torch.zeros(ch, dtype=bf16, device=device)
        bench(name, dw_chain, (x, wt, b), 2 * x.numel() * 2)
        del x
    x = B.from_nhwc(bench.rand(SHAPES["dec4_out (128,112,112,56)"], bf16))
    wt = bench.rand((56, 56, 1, 1), bf16, 0.1).contiguous(memory_format=torch.channels_last)
    bench("pw 56->56 @112^2", pw_chain, (x, wt, torch.zeros(56, dtype=bf16, device=device)),
          2 * x.numel() * 2)
    del x
    # 4. matmul rates: bf16 on the tensor cores, f32 with TF32 off
    tflops = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for key, dtype in (("bf16", bf16), ("f32", torch.float32)):
            x = bench.rand((MM_N, MM_N), dtype, 0.1)
            w = bench.rand((MM_N, MM_N), dtype, 0.1)
            row = bench(f"matmul {MM_N}^3 {key} (x{MM_PASSES})", mm_chain, (x, w),
                        3 * MM_N * MM_N * x.element_size(), k=MM_PASSES)
            tflops[key] = 2.0 * MM_N ** 3 / (row["per_pass_us"] / 1e6) / 1e12
            log(f"matmul {key}: {tflops[key]:.1f} TFLOP/s")
            del x, w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # 5. K5's copy sweep
    sweep = P.copy_sweep(device, calls=calls)
    for r in sweep:
        log(f"copy K5 {r['bytes'] >> 20} MB, {r['chunk_bytes'] >> 10} KB per slot, prefetch "
            f"{int(r['prefetch'])}: {r['GBs']:.1f} GB/s device, {r['GBs_events']:.1f} GB/s events")

    ceiling_rows = [(r["name"], r["GBs"]) for r in bench.rows if "256MB" in r["name"]]
    ceiling_rows += [(f"copy K5 256MB chunk {r['chunk_bytes'] >> 10}KB prefetch "
                      f"{int(r['prefetch'])}", r["GBs"]) for r in sweep if r["hbm_ceiling"]]
    src, best = max(ceiling_rows, key=lambda r: r[1])
    too_fast = [(n, g) for n, g in ceiling_rows if g > DATA_SHEET["hbm_GBs"]]
    if too_fast:
        raise RuntimeError(f"256 MB rows read above the data sheet's {DATA_SHEET['hbm_GBs']} "
                           f"GB/s, which means L2, not device memory: {too_fast}")
    f32_fma = DATA_SHEET["f32_tflops"] * 1e12 / 2
    return {
        "card": card, "K": K, "calls": calls, "data_sheet": DATA_SHEET, "rows": bench.rows,
        "matmul_tflops": tflops, "copy_sweep": sweep, "l2_note": P.L2_NOTE,
        "ceilings": {
            "hbm_bps": best * 1e9, "hbm_source": src,
            "pointwise_macs": {k: v * 1e12 / 2 for k, v in tflops.items()},
            "pointwise_source": f"matmul {MM_N}^3 rows (bf16; f32 with TF32 off)",
            "depthwise_macs": f32_fma,
            "depthwise_source": (f"{DATA_SHEET['source']}: {DATA_SHEET['f32_tflops']} TFLOP/s "
                                 "f32 on the CUDA cores (not measured)"),
        },
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="measure the card's ceilings")
    p.add_argument("--calls", type=int, default=CALLS, help="chains per row")
    p.add_argument("--out", default=None, help="write the JSON here "
                   "(engine/roofline.py reads docs/probe_h100_hbm.json)")
    args = p.parse_args(argv)
    res = calibrate("cuda", calls=args.calls)
    c = res["ceilings"]
    print(f"{res['card']['nvidia_smi']}: device memory {c['hbm_bps'] / 1e9:.1f} GB/s "
          f"({c['hbm_source']}); matmul bf16 {res['matmul_tflops']['bf16']:.1f}, f32 "
          f"{res['matmul_tflops']['f32']:.1f} TFLOP/s; depthwise from the data sheet")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"json -> {args.out}")
    return res


if __name__ == "__main__":
    main()
