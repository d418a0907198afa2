"""Device augmentation's stages, each timed alone on the card — the port's
counterpart of ``scripts/probe_r5_device_gathers.py``.

``data/device_aug.apply_train_augment`` split into its lookups, each
timed on its own over the script's seeded inputs, and the whole function
beside them, so that the stage that costs the time is measured, not
guessed.  The port's ``data/device_aug`` has the gather form only; this
module also holds the JAX package's gather-free ``lut_impl="dot"`` forms
(:func:`jitter_slot_dot`, :func:`augment_dot`), which give the same bits,
to time them beside it.  Rows (b = ``--batch``, raw 480x640, output
224x224):

  rgb_u8_gather          torch.gather of (B, 307200, 3) uint8 by (B, N, 3)
  rgb_u32_gather         the same pixels packed in 32 bits: (B, 307200) by (B, N)
  depth_f32_gather       (B, 307200) f32 by (B, N)
  jitter_slot_2d         one jitter slot (saturation kind) in the dot form
                         (the script's: JAX's default), :func:`jitter_slot_dot`
  jitter_slot_2d_gather  the same slot as the port computes it,
                         ``device_aug._jitter_slot`` (added by the port)
  small_lut_256          (B, N, 3) values through per-image (B, 256) uint8 tables
  unit_lut_take          the /255: (B, N, 3) values looked up in the 256-entry f32 table
  pil_l_compute          the integer L plane and its sums, no lookup
  full_augment           the whole augmentation in the dot form, the script's
                         setting: :func:`augment_dot`
  full_augment_gather    ``device_aug.apply_train_augment`` (added by the port)

The dot forms (``fastdepth_tpu/data/device_aug.py``'s, exact: a u8 value
is exact in bf16, the one-hot factors are 0 or 1 and each reduction has
one nonzero term, so no order of accumulation, FMA contraction or
reduced-precision reduction changes a bit):

  slot   ``onehot(row) @ grid`` selects each pixel's grid row, then the row
         dotted with ``onehot(value)`` selects the value (:func:`two_dots`),
         in bf16 (an f32 product under TF32 would round); XLA fuses the
         one-hots into the products, eager PyTorch makes them (at b128 one
         slot's are 3.3 GB of row and 9.9 GB of value one-hots), so the
         slot runs :data:`DOT_CHUNK_BYTES` worth of images at a time;
  /255   the select-sum ``sum_k lut[k] * (v == k)`` over the host table's
         f32 entries (:func:`select_sum`).

The gathers index with int64 (``torch.gather``'s index type), widened
once with the inputs; the 32-bit pixels are held as int32 (torch has no
uint32 gather), the same bits.  Each row: 3 warm-up calls, then
``--calls`` calls timed as one span (``engine/benchmark.time_pipelined``,
CUDA events on the card), in ms a call.

    python -m fastdepth_tpu_torch.scripts.probe_r5_device_gathers [--batch 128]
        [--calls 10] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fastdepth_tpu_torch.scripts import _serving as S

RAW_HW = (480, 640)
OUT_HW = (224, 224)
WARMUP = 3
# the dot slot's working set: a chunk of images whose one-hots, row selects
# and value one-hots take at most this many bytes (each (pixel, 256) entry
# holds a bool and a bf16 one-hot of the row, its bf16 row, and three bool
# and three bf16 one-hots of the values: 14 bytes)
DOT_CHUNK_BYTES = 2 << 30
DOT_BYTES_PER_ENTRY = 14


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--calls", type=int, default=10)
    S.add_common(p, "probe_r5_device_gathers_h100.json")
    return p.parse_args(argv)


def onehot(v: torch.Tensor) -> torch.Tensor:
    """``(v[..., None] == arange(256))`` in bf16, ``v`` compared as int32
    (uint8 arithmetic would wrap)."""
    return (v.to(torch.int32)[..., None]
            == torch.arange(256, dtype=torch.int32, device=v.device)).to(torch.bfloat16)


def two_dots(row: torch.Tensor, v: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid[b, row[b, n], v[b, n, c]]`` for ``row`` (B, N), ``v`` (B, N, 3)
    and per-image grids (B, 256, 256), as two bf16 contractions: (B, N, 3)
    bf16."""
    b, n = row.shape
    rows = torch.bmm(onehot(row), grid.to(torch.bfloat16))               # (B, N, 256)
    vals = torch.bmm(onehot(v.reshape(b * n, 3)), rows.reshape(b * n, 256, 1))
    return vals.reshape(b, n, 3)


def select_sum(v: torch.Tensor, lut) -> torch.Tensor:
    """``sum_k lut[k] * (v == k)`` over a 256-entry table of Python floats
    (the entries as f32 constants), one add per entry, in f32."""
    vi = v.to(torch.int32)
    acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for k in range(256):
        acc.add_(vi == k, alpha=lut[k])
    return acc


def jitter_slot_dot(img_u8: torch.Tensor, table: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """``device_aug._jitter_slot`` in the dot form: the same rows
    (``device_aug._slot_rows``), looked up by :func:`two_dots`,
    :data:`DOT_CHUNK_BYTES` worth of images at a time."""
    from fastdepth_tpu_torch.data import device_aug as DA

    row = DA._slot_rows(img_u8, kind)
    b, n, _ = img_u8.shape
    step = max(1, DOT_CHUNK_BYTES // (n * 256 * DOT_BYTES_PER_ENTRY))
    return torch.cat([two_dots(row[i:i + step], img_u8[i:i + step], table[i:i + step])
                      .to(torch.uint8) for i in range(0, b, step)])


def unit_lut():
    """The host's u8 -> [0, 1] table (``native.u8_to_unit_f32``) as a list
    of Python floats."""
    from fastdepth_tpu_torch.data import native

    return native.u8_to_unit_f32(np.arange(256, dtype=np.uint8)).tolist()


def augment_dot(rgb_raw, depth_raw, flat, scale, tables, kinds, out_size=OUT_HW):
    """``device_aug.apply_train_augment`` in the dot form: the same spatial
    gather, each slot by :func:`jitter_slot_dot`, the /255 by
    :func:`select_sum`; the same bits."""
    from fastdepth_tpu_torch.data import device_aug as DA

    b = rgb_raw.shape[0]
    oh, ow = out_size
    rgb_g, depth_g = DA._spatial_gather(rgb_raw, depth_raw, flat, scale)
    for s in range(kinds.shape[1]):
        rgb_g = jitter_slot_dot(rgb_g, tables[:, s], kinds[:, s])
    return (select_sum(rgb_g, unit_lut()).reshape(b, oh, ow, 3),
            depth_g.reshape(b, oh, ow, 1))


def make_inputs(b: int, seed: int = 0) -> dict:
    """The script's numpy inputs at batch ``b``, drawn from
    ``RandomState(seed)`` in its order (scripts/probe_r5_device_gathers.py:
    52-62, 102-104)."""
    from fastdepth_tpu_torch.data import device_aug as DA
    from fastdepth_tpu_torch.data import transforms as T

    n, hw = OUT_HW[0] * OUT_HW[1], RAW_HW[0] * RAW_HW[1]
    rng = np.random.RandomState(seed)
    x = {"rgb_u8": rng.randint(0, 256, (b, hw, 3)).astype(np.uint8),
         "rgb_u32": rng.randint(0, 2 ** 31, (b, hw), dtype=np.int64).astype(np.uint32),
         "depth": rng.rand(b, hw).astype(np.float32),
         "idx": rng.randint(0, hw, (b, n)).astype(np.int32),
         "vals": rng.randint(0, 256, (b, n, 3)).astype(np.uint8),
         "tab2d": np.stack([T.blend_grid(f) for f in rng.uniform(0.6, 1.4, b)]),
         "tab1d": rng.randint(0, 256, (b, 256)).astype(np.uint8),
         "kinds": np.full(b, DA.KIND_SATURATION, np.int32)}
    x["flat"] = np.where(rng.rand(b, n) < 0.02, -1,
                         rng.randint(0, hw, (b, n))).astype(np.int32)
    x["scale"] = (rng.rand(b) * 0.5 + 1.0).astype(np.float32)
    x["tables"] = np.stack([x["tab2d"]] * 3, axis=1)
    x["kinds3"] = np.tile(np.array([1, 2, 3], np.int32), (b, 1))
    return x


def stages(x: dict, device: str) -> dict:
    """``{tag: (fn, args)}``: each row's function and its arguments on
    ``device``, built from :func:`make_inputs`."""
    from fastdepth_tpu_torch.data import device_aug as DA

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    b = x["rgb_u8"].shape[0]
    idx = t(x["idx"]).long()
    rgb_u8, vals, tab2d, kinds = t(x["rgb_u8"]), t(x["vals"]), t(x["tab2d"]), t(x["kinds"])
    unit = DA._unit_lut(torch.device(device))
    aug_args = (rgb_u8.reshape(b, *RAW_HW, 3), t(x["depth"]).reshape(b, *RAW_HW), t(x["flat"]),
                t(x["scale"]), t(x["tables"]), t(x["kinds3"]))

    def pil_l(v):
        lp = DA._pil_l(v)
        return lp, lp.sum(-1, dtype=torch.int32)

    return {
        "rgb_u8_gather": (lambda a, i: torch.gather(a, 1, i[..., None].expand(-1, -1, 3)),
                          (rgb_u8, idx)),
        "rgb_u32_gather": (lambda a, i: torch.gather(a, 1, i),
                           (t(x["rgb_u32"].view(np.int32)), idx)),
        "depth_f32_gather": (lambda a, i: torch.gather(a, 1, i), (t(x["depth"]), idx)),
        "jitter_slot_2d": (jitter_slot_dot, (vals, tab2d, kinds)),
        "jitter_slot_2d_gather": (DA._jitter_slot, (vals, tab2d, kinds)),
        "small_lut_256": (lambda v, g: torch.gather(g, 1, v.long().reshape(b, -1)).reshape(
            v.shape), (vals, t(x["tab1d"]))),
        "unit_lut_take": (lambda v: unit[v.long()], (vals,)),
        "pil_l_compute": (pil_l, (vals,)),
        "full_augment": (augment_dot, aug_args),
        "full_augment_gather": (lambda *a: DA.apply_train_augment(*a, out_size=OUT_HW),
                                aug_args),
    }


def time_ms(fn, args, calls: int, device: str) -> float:
    """ms a call: :data:`WARMUP` calls, then ``calls`` timed as one span."""
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    return time_pipelined(fn, args, warmup=WARMUP, calls=calls, device=device)["mean_s"] * 1e3


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = S.check_device(args.device)
    results = {"batch": args.batch, "calls": args.calls, "rows": {}}
    for tag, (fn, a) in stages(make_inputs(args.batch), args.device).items():
        results["rows"][tag] = round(time_ms(fn, a, args.calls, args.device), 4)
        print(json.dumps({tag: results["rows"][tag]}), flush=True)
    results["card"] = card
    S.write_json(args.out, results)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
