"""Train augmentation on the device — counterpart of
``fastdepth_tpu/data/device_aug.py`` (its gather form).

The host half of a train item (``data/pipeline.py::TrainPipeline``) is
parameter math (drawing scale, angle, flip and the jitter plan, and
composing the geometry into one flat raw -> 224x224 gather map) and pixel
math (the ~1M-element gather, the PIL-exact enhance chain and the /255).
With ``NYUDataset(device_augment=True)`` the host ships raw frames plus
the parameters, and :func:`apply_train_augment` does all the pixel math
on the tensors' device, bit for bit with the host pipeline
(tests/test_torch_device_aug.py holds it there and against the JAX
package).

Where exactness breaks, and what this module does about it:

* gather: ``torch.gather`` takes int64 indices; the int32 map is widened
  here, on the device (widening on the host would double the bytes
  shipped).  The rotation pad is ``-1`` in the map and is masked before
  the gather: on CUDA an out-of-range index is a device-side assert, not
  JAX's clamp.
* depth: a true f32 division by the item's scale, a ``(B, 1)`` tensor on
  the device.  A division by a Python number or a 0-dim CPU tensor is a
  multiply by the reciprocal on CUDA (126 of 256 values 1 ulp off).
* enhance: no float arithmetic on the device.  The host bakes each
  enhance op into a (256, 256) uint8 value grid (``transforms.blend_grid``,
  bit-equal to PIL) and the device computes integer row indices only: the
  pixel's fixed-point 'L' gray for saturation, the image's mean-L gray
  for contrast as ``(2*sum + n) // (2*n)`` in int64, row 0 for
  brightness.  uint8 is promoted to int32 before the multiplies (uint8
  arithmetic wraps; the largest sum, 255*65536 + 32768, is below 2^31).
* /255: a lookup in the host's table of correctly rounded quotients
  (``native.u8_to_unit_f32``), never a division.

The op order of ColorJitter is drawn per item, so each item carries three
slots (grid + row kind); unused slots hold the identity grid.

The JAX package also has one-hot ``dot`` forms of the lookups, there to
escape a TPU gather floor; they compute the same values, and only the
gather form is ported.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# slot kinds (NYUDataset device-augment items; 0 pads unused slots)
KIND_NONE = 0
KIND_BRIGHTNESS = 1   # degenerate: black        (ImageEnhance.Brightness)
KIND_CONTRAST = 2     # degenerate: mean-L gray  (ImageEnhance.Contrast)
KIND_SATURATION = 3   # degenerate: per-pixel L  (ImageEnhance.Color)


def _pil_l(img_u8: torch.Tensor) -> torch.Tensor:
    """Pillow's convert('L') fixed point over (..., 3) uint8 -> (...) int32
    (csrc/preprocess.cpp::pil_l)."""
    px = img_u8.to(torch.int32)
    return (px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471 + 0x8000) >> 16


def _jitter_slot(img_u8: torch.Tensor, table: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """One enhance slot over a (B, N, 3) uint8 batch: an integer row select
    and a value lookup.  ``table`` (B, 256, 256) uint8 is the op's
    host-baked PIL-blend grid; ``kind`` (B,) picks the row: the pixel's L
    (saturation), the image's mean L (contrast) or row 0 (brightness,
    identity)."""
    l_plane = _pil_l(img_u8)                                   # (B, N) int32
    n = l_plane.shape[-1]
    # ImageEnhance.Contrast: int(mean(L) + 0.5), exactly, in integers
    gray = (2 * l_plane.sum(-1, dtype=torch.int64) + n) // (2 * n)     # (B,) int64
    k = kind[:, None]
    row = torch.where(k == KIND_SATURATION, l_plane.long(),
                      torch.where(k == KIND_CONTRAST, gray[:, None], 0))  # (B, N) int64
    idx = row[..., None] * 256 + img_u8.long()                # (B, N, 3)
    b = img_u8.shape[0]
    return torch.gather(table.reshape(b, 256 * 256), 1, idx.reshape(b, -1)).reshape(img_u8.shape)


@functools.lru_cache(maxsize=None)
def _unit_lut(device: torch.device) -> torch.Tensor:
    """The host's u8 -> [0, 1] f32 table (``float(i) / 255.0f``, each entry
    the correctly rounded quotient) on ``device``; callers only read it."""
    from fastdepth_tpu_torch.data import native

    return torch.from_numpy(native.u8_to_unit_f32(np.arange(256, dtype=np.uint8))).to(device)


def _u8_to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] f32 by lookup in :func:`_unit_lut`."""
    return _unit_lut(img_u8.device)[img_u8.long()]


def apply_train_augment(
    rgb_raw: torch.Tensor,
    depth_raw: torch.Tensor,
    flat: torch.Tensor,
    scale: torch.Tensor,
    tables: torch.Tensor,
    kinds: torch.Tensor,
    out_size: Tuple[int, int] = (224, 224),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train item's pixel pipeline on the tensors' device.

    Args (leading B = batch, all on one device):
      rgb_raw   (B, Hr, Wr, 3)   uint8 raw frames,
      depth_raw (B, Hr, Wr)      f32 raw depth,
      flat      (B, oh*ow)       int32 composed raw -> output gather map,
                                 -1 = the rotation's constant pad (-> 0),
      scale     (B,)             f32 draw scale s (depth /= s, nyu.py:28),
      tables    (B, S, 256, 256) uint8 jitter slot value grids,
      kinds     (B, S)           int32 jitter slot row kinds (KIND_*).

    Returns (rgb (B, oh, ow, 3) f32 in [0, 1], depth (B, oh, ow, 1) in
    ``depth_raw``'s dtype), NHWC, bit for bit the host's
    ``TrainPipeline.__call__`` + ColorJitter items."""
    b = rgb_raw.shape[0]
    oh, ow = out_size
    mask = flat < 0
    idx = torch.where(mask, 0, flat).long()                   # masked, then widened
    rgb_g = torch.gather(rgb_raw.reshape(b, -1, 3), 1, idx[..., None].expand(-1, -1, 3))
    rgb_g = rgb_g.masked_fill(mask[..., None], 0)
    depth_g = torch.gather(depth_raw.reshape(b, -1), 1, idx)
    depth_g = torch.where(mask, 0.0, depth_g / scale[:, None])
    for s in range(kinds.shape[1]):
        rgb_g = _jitter_slot(rgb_g, tables[:, s], kinds[:, s])
    return _u8_to_unit(rgb_g).reshape(b, oh, ow, 3), depth_g.reshape(b, oh, ow, 1)
