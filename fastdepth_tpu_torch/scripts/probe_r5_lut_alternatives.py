"""Gather-free lookup formulations, measured on the card — the port's
counterpart of ``scripts/probe_r5_lut_alternatives.py``.

The JAX package chose its one-hot ``"dot"`` lookups because a TPU gather
costs a fixed time an index; this module times the same formulations in
eager PyTorch on the card, where each is its kernels one after another:

  256-entry tables (the jitter / 255 class), (B, 224*224*3) uint8 values:
    take_256         ``lut[v]``, the lookup itself
    onehot_dot       ``onehot(v) @ lut`` in bf16, the one-hot materialised
    select_sum       ``sum_k lut[k] * (v == k)`` over 256 f32 constants
                     (``probe_r5_device_gathers.select_sum``, its /255)
    select_sum_bt    per-image tables (B, 256): ``sum_k lut_b[:, k] * (v == k)``
    onehot_dot_bt    per-image tables, one batched product
  (256, 256) per-image grids (the saturation slot):
    sat_two_dots     ``onehot(L) @ grid`` selects the rows, then
                     ``rows . onehot(v)`` the values, in bf16
                     (``probe_r5_device_gathers.two_dots``, its slot, here
                     on the whole batch at once)
  the spatial gather packed in slices:
    block_gather_16  a gather of one 32-element slice per 16 output pixels
                     (``starts[..., None] + arange(32)``), then a 16-way
                     select on offsets in the slice: the cost of the
                     mechanism (rotation breaks it, so it cannot replace
                     the per-pixel gather)

An out-of-memory error of a row (``torch.OutOfMemoryError``) is itself
the datum and goes into ``errors``.  The 32-bit pixels are held as int32
(torch has no uint32 gather), the same bits.  Each row: 3 warm-up calls,
then ``--calls`` calls timed as one span (``engine/benchmark.
time_pipelined``, CUDA events on the card), in ms a call.

    python -m fastdepth_tpu_torch.scripts.probe_r5_lut_alternatives [--batch 32]
        [--calls 10] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fastdepth_tpu_torch.scripts import _serving as S
from fastdepth_tpu_torch.scripts.probe_r5_device_gathers import (
    OUT_HW, RAW_HW, onehot, select_sum, time_ms, two_dots)

NPX = OUT_HW[0] * OUT_HW[1]
N = NPX * 3  # lookups an image (the rgb channels)
BLOCK = 16  # output pixels a slice serves
SLICE = 32  # elements a slice reads


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--calls", type=int, default=10)
    S.add_common(p, "probe_r5_lut_alternatives_h100.json")
    return p.parse_args(argv)


def make_inputs(b: int, seed: int = 0) -> dict:
    """The script's numpy inputs at batch ``b``, drawn from
    ``RandomState(seed)`` in its order (scripts/probe_r5_lut_alternatives.
    py:57-70)."""
    hw = RAW_HW[0] * RAW_HW[1]
    rng = np.random.RandomState(seed)
    return {"v": rng.randint(0, 256, (b, N)).astype(np.uint8),
            "lut": rng.rand(256).astype(np.float32),
            "lut_b": rng.rand(b, 256).astype(np.float32),
            "grid_b": rng.rand(b, 256, 256).astype(np.float32),
            "lpx": rng.randint(0, 256, (b, NPX)).astype(np.int32),
            "raw32": rng.randint(0, 2 ** 31, (b, hw), dtype=np.int64).astype(np.uint32),
            "starts": rng.randint(0, hw - SLICE, (b, NPX // BLOCK)).astype(np.int32),
            "offs": rng.randint(0, BLOCK, (b, NPX)).astype(np.int32)}


def stages(x: dict, device: str) -> dict:
    """``{tag: (fn, args)}``: each row's function and its arguments on
    ``device``, built from :func:`make_inputs`."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    b = x["v"].shape[0]
    lut, lut_b = t(x["lut"]), t(x["lut_b"])
    lut_host = x["lut"].tolist()  # the table's entries as f32 constants
    lpx = t(x["lpx"])
    grid_b = t(x["grid_b"])

    def take_256(v):
        return lut[v.long()]

    def onehot_dot(v):
        return onehot(v) @ lut.to(torch.bfloat16)

    def select_sum_bt(v):
        vi = v.to(torch.int32)
        acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for k in range(256):
            acc.addcmul_(lut_b[:, k, None], vi == k)
        return acc

    def onehot_dot_bt(v):
        return torch.bmm(onehot(v), lut_b.to(torch.bfloat16)[..., None])[..., 0]

    def block_gather_16(raw32, starts, offs):
        # one SLICE-element slice per BLOCK output pixels, then a BLOCK-way
        # select over the offsets in the slice
        cols = starts.long()[..., None] + torch.arange(SLICE, device=starts.device)
        sl = torch.gather(raw32, 1, cols.reshape(b, -1)).reshape(b, -1, 1, SLICE)
        blk = sl.expand(-1, -1, BLOCK, -1).reshape(b, NPX, SLICE)
        out = torch.zeros((b, NPX), dtype=raw32.dtype, device=raw32.device)
        for j in range(BLOCK):
            out = out + torch.where(offs == j, blk[..., j], 0)
        return out

    v = t(x["v"])
    return {"take_256": (take_256, (v,)), "onehot_dot": (onehot_dot, (v,)),
            "select_sum": (lambda v: select_sum(v, lut_host), (v,)),
            "select_sum_bt": (select_sum_bt, (v,)), "onehot_dot_bt": (onehot_dot_bt, (v,)),
            "sat_two_dots": (lambda lpx, v: two_dots(lpx, v.reshape(b, NPX, 3), grid_b),
                             (lpx, v)),
            "block_gather_16": (block_gather_16, (t(x["raw32"].view(np.int32)),
                                                  t(x["starts"]), t(x["offs"])))}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = S.check_device(args.device)
    b = args.batch
    results = {"batch": b, "calls": args.calls, "lookups_per_call": b * N, "rows": {},
               "errors": {}}
    for tag, (fn, a) in stages(make_inputs(b), args.device).items():
        try:
            results["rows"][tag] = round(time_ms(fn, a, args.calls, args.device), 4)
            print(json.dumps({tag: results["rows"][tag]}), flush=True)
        except torch.OutOfMemoryError as e:
            results["errors"][tag] = f"{type(e).__name__}: {str(e)[:200]}"
            print(json.dumps({tag: results["errors"][tag]}), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    results["card"] = card
    S.write_json(args.out, results)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
