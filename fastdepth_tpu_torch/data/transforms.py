"""Host-side preprocessing primitives with exact reference semantics.

The reference pipeline (reference dataloaders/transforms.py) leans on the
long-deprecated ``scipy.misc.imresize`` (removed in modern scipy) plus
PIL and ``scipy.ndimage``.  Bit-for-bit metric parity requires replaying
its quirks exactly (SURVEY.md §7 'Hard parts'):

* ``imresize`` converts through a PIL image: float sizes mean
  ``(int(w*f), int(h*f))`` (truncation), 2-D float arrays go through
  mode 'F', and the default interpolation is **nearest**
  (transforms.py:311-341),
* PIL NEAREST maps  dst -> src = floor((dst + 0.5) * in/out),
* CenterCrop offsets use Python banker's rounding (transforms.py:370-374),
* Rotate is ``scipy.ndimage.rotate(order=0, reshape=False,
  prefilter=False)`` (transforms.py:288-308).

Instead of running these per item through PIL (reference hot spot,
SURVEY.md §3.2), every nearest-resize/crop here is expressed as a pair of
**gather index vectors**, so whole pipelines compose into a single fancy-
index per image (see pipeline.py) — the host analogue of kernel
fusion.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def nearest_resize_indices(in_size: int, out_size: int) -> np.ndarray:
    """PIL NEAREST source index for each destination pixel.

    PIL's affine-nearest path initializes xx = scale * 0.5 and then
    *accumulates* xx += scale per destination pixel in double precision,
    truncating each value — NOT the closed form floor((x+0.5)*scale);
    the two differ by 1 ulp exactly where metric parity dies.  Verified
    identical to Pillow across 22k (in, out) size pairs
    (tests/test_transforms.py).
    """
    a0 = in_size / out_size
    steps = np.full(out_size, a0, dtype=np.float64)
    steps[0] = a0 * 0.5
    centers = np.add.accumulate(steps)  # strict left-to-right, like PIL's loop
    return np.clip(centers.astype(np.int64), 0, in_size - 1)


def imresize_output_size(h: int, w: int, size) -> Tuple[int, int]:
    """Replicates scipy.misc.imresize size handling: int = percent,
    float = fraction (PIL size tuple truncates), tuple = (h, w)."""
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    if isinstance(size, (int, np.integer)):
        f = size / 100.0
    else:
        f = float(size)
    # scipy computes the PIL (w, h) tuple as (array(im.size) * f).astype(int)
    return int(h * f), int(w * f)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """imresize(img, size, 'nearest'[, 'F']) equivalent for 2-D/3-D arrays.

    NOTE: for uint8 inputs scipy returns uint8; for 2-D float ('F' mode)
    it returns float32 — nearest never changes values, only gathers, so
    dtype is preserved here (float64 depth stays float64; the pipeline
    casts once at the end like ToTensor's .float(), transforms.py:195-224).
    """
    h, w = img.shape[:2]
    th, tw = imresize_output_size(h, w, size)
    rows = nearest_resize_indices(h, th)
    cols = nearest_resize_indices(w, tw)
    return img[rows][:, cols]


# ---------------------------------------------------------------------------
# Convolution-based resize modes (reference transforms.py:311-341 accepts
# interp = 'bilinear' / 'bicubic' / 'cubic' / 'lanczos' in addition to the
# default 'nearest'; scipy.misc.imresize routed them to PIL Image.resize).
# Unused by the NYU pipeline, provided for full transform-library parity.
#
# This is a NumPy re-implementation of Pillow's ImagingResample
# (libImaging/Resample.c): separable horizontal-then-vertical passes; for
# uint8 images the coefficients are quantized to int32 fixed point with
# PRECISION_BITS = 22 and each pass re-quantizes to uint8 (clip8); for
# mode-'F' images each pass accumulates in float64 and stores float32.
# Accumulation below walks the taps in PIL's exact left-to-right order so
# the float path is bit-identical too, not just close.  Verified against
# Pillow across thousands of (size, filter, dtype) cases in
# tests/test_transforms.py.

_PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c


def _filter_bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _filter_bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5  # Keys kernel, Pillow's choice
    x = np.abs(x)
    r1 = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    r2 = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, r1, np.where(x < 2.0, r2, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    xp = x * np.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(x == 0.0, 1.0, np.sin(xp) / xp)


def _filter_lanczos(x: np.ndarray) -> np.ndarray:
    # Pillow uses the half-open window [-3, 3)
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


_PIL_FILTERS = {
    "bilinear": (1.0, _filter_bilinear),
    "bicubic": (2.0, _filter_bicubic),
    "cubic": (2.0, _filter_bicubic),  # imresize aliased 'cubic' to bicubic
    "lanczos": (3.0, _filter_lanczos),
}


def _resample_coeffs(in_size: int, out_size: int, interp: str):
    """Pillow precompute_coeffs: per-dst-pixel (xmin, taps[ksize]) in f64."""
    support0, filt = _PIL_FILTERS[interp]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = (xx + 0.5) * scale
    # C truncation toward zero; operands here are always > -support
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize, dtype=np.float64)[None, :]
    # C precomputes ss = 1/filterscale and multiplies — a division here
    # is 1 ulp off for some taps, which flips final float32 roundings
    w = filt((taps + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w[taps >= xmax[:, None]] = 0.0  # beyond xmax: stays empty
    # C sums ww tap-by-tap; numpy's pairwise sum() is 1 ulp off for some
    # coefficient sets, which flips final float32 roundings downstream
    ww = np.zeros((out_size, 1), np.float64)
    for t in range(ksize):
        ww += w[:, t : t + 1]
    w = np.divide(w, ww, out=w, where=ww != 0.0)
    return xmin, xmax, w


def _quantize_coeffs(w: np.ndarray) -> np.ndarray:
    """Pillow normalize_coeffs_8bpc: (int)(k * 2^22 ± 0.5), trunc to zero."""
    s = w * float(1 << _PRECISION_BITS)
    return (np.where(s < 0, s - 0.5, s + 0.5)).astype(np.int64)


def _resample_axis0(img: np.ndarray, out_size: int, interp: str) -> np.ndarray:
    """One Pillow resample pass along axis 0 (rows). uint8 in -> uint8 out
    via the fixed-point path; anything else -> float32 via the 32bpc path.
    Tap loop preserves PIL's accumulation order exactly."""
    in_size = img.shape[0]
    xmin, xmax, w = _resample_coeffs(in_size, out_size, interp)
    ksize = w.shape[1]
    flat = img.reshape(in_size, -1)
    if img.dtype == np.uint8:
        kk = _quantize_coeffs(w)
        acc = np.full((out_size, flat.shape[1]), 1 << (_PRECISION_BITS - 1),
                      np.int64)
        for t in range(ksize):
            idx = np.minimum(xmin + t, in_size - 1)  # zero-coeff taps: any row
            acc += flat[idx].astype(np.int64) * kk[:, t : t + 1]
        out = (acc >> _PRECISION_BITS).clip(0, 255)
        out[acc >= (1 << _PRECISION_BITS << 8)] = 255
        out[acc <= 0] = 0
        return out.astype(np.uint8).reshape((out_size,) + img.shape[1:])
    src = flat.astype(np.float64, copy=False)
    acc = np.zeros((out_size, flat.shape[1]), np.float64)
    for t in range(ksize):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += src[idx] * w[:, t : t + 1]
    return acc.astype(np.float32).reshape((out_size,) + img.shape[1:])


def _bytescale(data: np.ndarray) -> np.ndarray:
    """scipy.misc.bytescale default path (toimage normalized non-uint8
    arrays through this before resizing)."""
    cmin, cmax = float(data.min()), float(data.max())
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1.0
    scaled = (data - cmin) * (255.0 / cscale)
    return (scaled.clip(0, 255) + 0.5).astype(np.uint8)


def resize(img: np.ndarray, size, interp: str = "nearest",
           mode: Optional[str] = None) -> np.ndarray:
    """scipy.misc.imresize(img, size, interp[, mode]) for every interp the
    reference Resize accepts (reference transforms.py:311-341).

    * nearest: exact gather (resize_nearest), dtype-preserving.
    * bilinear/bicubic/cubic/lanczos: Pillow-exact separable resample.
      uint8 input stays on the quantized uint8 path; 2-D or mode='F'
      input takes the float32 path (imresize cast floats via PIL mode
      'F'); non-uint8 3-D input is bytescaled to uint8 first, matching
      scipy's toimage normalization.
    """
    if interp == "nearest":
        return resize_nearest(img, size)
    if interp not in _PIL_FILTERS:
        raise ValueError(f"unknown interpolation {interp!r}")
    h, w = img.shape[:2]
    th, tw = imresize_output_size(h, w, size)
    if mode == "F":
        out = np.asarray(img, np.float32)
    elif img.dtype == np.uint8:
        # scipy toimage: 2-D uint8 -> mode 'L', 3-D uint8 -> 'RGB' —
        # both ride PIL's quantized fixed-point path and return uint8
        out = img
    elif img.ndim == 2:
        out = np.asarray(img, np.float32)  # imresize 2-D float -> 'F'
    else:
        out = _bytescale(np.asarray(img))
    # Pillow ImagingResampleInner: horizontal pass first, then vertical;
    # a pass whose size is unchanged is skipped entirely (identity).
    if tw != w:
        out = _resample_axis0(out.swapaxes(0, 1), tw, interp).swapaxes(0, 1)
    if th != h:
        out = _resample_axis0(out, th, interp)
    if out is img or out.base is img:
        # both passes skipped (or a no-copy cast): PIL always returns a
        # fresh buffer — never alias the caller's source image
        out = out.copy()
    return out


class Resize:
    """Reference transforms.py:311-341 class surface: size may be a float
    fraction, int percent, or (h, w) tuple; interp defaults to nearest;
    2-D arrays ride the mode-'F' float path."""

    def __init__(self, size, interpolation: str = "nearest"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:
            return resize(img, self.size, self.interpolation)
        if img.ndim == 2:
            return resize(img, self.size, self.interpolation, mode="F")
        raise RuntimeError(
            f"img should be ndarray with 2 or 3 dimensions. Got {img.ndim}"
        )


def center_crop_offsets(h: int, w: int, th: int, tw: int) -> Tuple[int, int]:
    """Banker's-rounded center offsets (reference transforms.py:370-374)."""
    return int(round((h - th) / 2.0)), int(round((w - tw) / 2.0))


def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    th, tw = size
    i, j = center_crop_offsets(img.shape[0], img.shape[1], th, tw)
    return img[i : i + th, j : j + tw]


def horizontal_flip(img: np.ndarray, do_flip: bool) -> np.ndarray:
    return np.fliplr(img) if do_flip else img


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """Nearest-neighbor rotation, no reshape (reference transforms.py:306-308)."""
    from scipy import ndimage

    return ndimage.rotate(img, angle, reshape=False, prefilter=False, order=0)


def rotate_nearest_indices(h: int, w: int, angle: float) -> np.ndarray:
    """(h, w) flat gather map of ``scipy.ndimage.rotate(..., reshape=False,
    order=0, mode='constant')``; -1 marks the constant-pad region.

    Bit-identical to rotating an index plane through scipy (sweep-tested
    vs ndimage over dense angle/shape grids incl. exact .5-tie angles)
    but ~15x cheaper: scipy's per-point C loop is replaced by three
    broadcast FMAs.  The exact replication needs (a) scipy's degree-exact
    trig (``special.cosdg``/``sindg``, NOT cos(radians(angle))), (b) its
    accumulation order ``offset + M00*y + M01*x`` (ties at .5 flip under
    any other association), (c) order-0 rounding ``floor(coord + 0.5)``
    with the UNROUNDED coordinate bounds-checked against [0, len-1]."""
    from scipy import special

    c, s = special.cosdg(angle), special.sindg(angle)
    # the offset must come from the SAME matmul scipy's rotate performs
    # (scipy/ndimage/_interpolation.py::rotate) — scalar re-association
    # shifts it by an ulp and flips .5-tie pixels
    center = (np.array([h, w]) - 1) / 2
    off_y, off_x = center - np.array([[c, s], [-s, c]]) @ center
    ys = np.arange(h, dtype=np.float64)
    xs = np.arange(w, dtype=np.float64)
    # same elementwise float-op association as scipy's accumulation:
    # ((offset + M00*y) + M01*x)
    iny = (off_y + c * ys)[:, None] + (s * xs)[None, :]
    inx = (off_x + (-s) * ys)[:, None] + (c * xs)[None, :]
    ry = np.floor(iny + 0.5).astype(np.int64)
    rx = np.floor(inx + 0.5).astype(np.int64)
    valid = (iny >= 0) & (iny <= h - 1) & (inx >= 0) & (inx <= w - 1)
    return np.where(valid, ry * w + rx, -1)


class Compose:
    """Chain transforms (reference transforms.py:173-192)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Lambda:
    """User-defined transform (reference transforms.py:470-482)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, img):
        return self.fn(img)


def to_nhwc_tensor(img: np.ndarray) -> np.ndarray:
    """HWC/HW float32 output array — the NHWC-world ToTensor.

    The reference's ToTensor transposes HWC->CHW for torch
    (transforms.py:195-224, note: float cast, NO /255); the channels-last layout is
    channels-last so only the float cast remains."""
    if img.ndim == 2:
        img = img[..., None]
    return np.asarray(img, np.float32)


def normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """Per-channel (x - mean) / std (reference transforms.py:227-286;
    defined-but-unused in the reference NYU pipeline — normalization is
    the /255 at nyu.py:43,56 — provided for API completeness)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (np.asarray(img, np.float32) - mean) / std


def bottom_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Crop anchored at the bottom edge, centered horizontally
    (reference transforms.py:407-468; used by the KITTI-era pipeline)."""
    th, tw = size
    i = img.shape[0] - th
    j = int(round((img.shape[1] - tw) / 2.0))
    return img[i : i + th, j : j + tw]


def crop(img: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    """Explicit-rectangle crop (reference transforms.py:580-622)."""
    return img[i : i + h, j : j + w]


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    """Power-law transform on uint8 RGB (reference transforms.py:139-170)."""
    if gamma < 0:
        raise ValueError("gamma must be non-negative")
    x = np.asarray(img, np.float32)
    out = 255.0 * gain * ((x / 255.0) ** gamma)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Class surfaces mirroring the remaining reference transform objects
# (reference transforms.py:195-622).  The framework's pipelines use the
# fused functional/gather forms above; these thin wrappers keep the
# reference's compositional API available 1:1 for library users.


class ToTensor:
    """Reference transforms.py:195-224 — float cast, NO /255.  The
    reference transposes HWC->CHW for torch; the channels-last layout is
    channels-last, so the NHWC array form is the tensor here.

    Exactly like the reference, a 2-D input stays 2-D (H,W) — the
    reference's dataloader unsqueezes depth to 1xHxW afterwards
    (dataloader.py:104-109).  For a depth map that should come out
    (H,W,1) directly, use :func:`to_nhwc_tensor` instead; the two
    surfaces deliberately differ on 2-D inputs."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if not isinstance(img, np.ndarray):
            # reference type guard (transforms.py:210-211)
            raise TypeError(f"img should be ndarray. Got {type(img)}")
        if img.ndim not in (2, 3):
            raise RuntimeError(
                f"img should be ndarray with 2 or 3 dimensions. Got {img.ndim}")
        return np.asarray(img, np.float32)


class NormalizeNumpyArray:
    """Reference transforms.py:227-256 (defined-but-unused in the NYU
    pipeline there, same here)."""

    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.ndim != 3:
            raise RuntimeError(
                f"img should be ndarray with 3 dimensions. Got {img.ndim}")
        return normalize(img, self.mean, self.std)


class NormalizeTensor(NormalizeNumpyArray):
    """Reference transforms.py:258-286 — in the NHWC-array world the
    tensor and ndarray forms coincide."""

    def __call__(self, tensor: np.ndarray) -> np.ndarray:
        return normalize(tensor, self.mean, self.std)


class Rotate:
    """Reference transforms.py:288-308."""

    def __init__(self, angle: float):
        self.angle = angle

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return rotate(img, self.angle)


def _as_hw(size) -> tuple:
    """int -> square (h, w); sequence -> tuple (the reference's crop-size
    normalization, transforms.py:353-357/:416-420) — shared so the two
    crop classes can't drift."""
    import numbers

    if isinstance(size, numbers.Number):
        return (int(size), int(size))
    return tuple(size)


class CenterCrop:
    """Reference transforms.py:344-405 (banker's-rounded offsets).
    ``size``: sequence (h, w), or an int for a square crop
    (reference :353-357)."""

    def __init__(self, size):
        self.size = _as_hw(size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return center_crop(img, self.size)


class BottomCrop:
    """Reference transforms.py:407-468.  ``size``: sequence (h, w), or
    an int for a square crop (reference :416-420)."""

    def __init__(self, size):
        self.size = _as_hw(size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return bottom_crop(img, self.size)


class HorizontalFlip:
    """Reference transforms.py:485-510 — flip decision is drawn by the
    caller (the reference draws it in the dataset too, nyu.py:30)."""

    def __init__(self, do_flip: bool):
        self.do_flip = do_flip

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return horizontal_flip(img, self.do_flip)


class Crop:
    """Reference transforms.py:580-622 (explicit rectangle, with the
    reference's bounds checks)."""

    def __init__(self, i: int, j: int, h: int, w: int):
        self.i, self.j, self.h, self.w = i, j, h, w

    def __call__(self, img: np.ndarray) -> np.ndarray:
        i, j, h, w = self.i, self.j, self.h, self.w
        if not (0 <= i <= img.shape[0] - h and 0 <= j <= img.shape[1] - w):
            raise ValueError(f"crop ({i},{j},{h},{w}) outside {img.shape}")
        return crop(img, i, j, h, w)


# ---------------------------------------------------------------------------
# Color jitter (train-time only; reference transforms.py:513-578 applies
# PIL ImageEnhance ops in random order with random factors).


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    from PIL import Image, ImageEnhance

    return np.array(ImageEnhance.Brightness(Image.fromarray(img)).enhance(factor))


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    from PIL import Image, ImageEnhance

    return np.array(ImageEnhance.Contrast(Image.fromarray(img)).enhance(factor))


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    from PIL import Image, ImageEnhance

    return np.array(ImageEnhance.Color(Image.fromarray(img)).enhance(factor))


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Cyclic hue shift through HSV (reference transforms.py:95-137)."""
    from PIL import Image

    if not (-0.5 <= factor <= 0.5):
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    pil = Image.fromarray(img)
    h, s, v = pil.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    with np.errstate(over="ignore"):
        # wraparound add on the H channel; `% 256` reproduces the
        # negative-factor wrap that np.uint8(negative float) performed
        # before NumPy 2 made that an OverflowError
        np_h += np.uint8(int(factor * 255) % 256)
    h = Image.fromarray(np_h, "L")
    return np.array(Image.merge("HSV", (h, s, v)).convert("RGB"))


def _pil_value_strip():
    """(1, 256, 3) uint8 RGB image holding every channel value once."""
    return np.broadcast_to(
        np.arange(256, dtype=np.uint8)[None, :, None], (1, 256, 3)).copy()


def _blend_lut(degenerate_rgb: Tuple[int, int, int], factor: float) -> np.ndarray:
    """256-entry value map of ``Image.blend(degenerate, img, factor)`` —
    built BY PIL on a strip of all 256 values, so it reproduces
    ImageEnhance's exact per-band arithmetic (incl. its float rounding
    and clipping) by construction rather than by reimplementation."""
    from PIL import Image

    strip = Image.fromarray(_pil_value_strip())
    degenerate = Image.new("RGB", strip.size, degenerate_rgb)
    return np.array(Image.blend(degenerate, strip, factor))[0, :, 0]


def blend_grid(factor: float) -> np.ndarray:
    """(256, 256) uint8 value map of PIL's blend: ``grid[d, v] =
    Image.blend(degenerate=d, value=v, factor)`` — stepwise float32
    ``d + factor * (v - d)`` with C-cast truncation and clipping
    (Pillow Blend.c; proven bit-equal to PIL/ImageEnhance across factor
    sweeps in tests/test_device_aug.py).

    One grid encodes a whole enhance op for the DEVICE jitter path
    (data/device_aug.py): saturation reads row = the pixel's own 'L'
    gray, contrast reads row = the image's mean-L gray, brightness
    reads row 0 (its degenerate is black).  numpy evaluates each f32
    step correctly rounded with no fused multiply-add — unlike an XLA
    float chain, where FMA contraction was measured flipping the
    truncation on ~0.3%% of pixels — so table-lookup on device is exact
    by construction on every backend.

    Dispatches to the C kernel (csrc fd_blend_grid, ~5x faster — the
    bake is per train item, so it is on the feeding path) when the
    native lib is built; the numpy form below is the semantic reference
    and the fallback, and tests/test_device_aug.py pins both to PIL."""
    from fastdepth_tpu_torch.data import native

    g = native.blend_grid(factor)
    if g is not None:
        return g
    d = np.arange(256, dtype=np.float32)[:, None]
    v = np.arange(256, dtype=np.float32)[None, :]
    m = (np.float32(factor) * (v - d)).astype(np.float32)
    t = (d + m).astype(np.float32)
    return np.clip(np.trunc(t), 0.0, 255.0).astype(np.uint8)


def identity_grid() -> np.ndarray:
    """(256, 256) pass-through value map (the device jitter's unused
    slots): out == value for every row."""
    return np.broadcast_to(
        np.arange(256, dtype=np.uint8)[None, :], (256, 256)).copy()


def adjust_brightness_fast(img: np.ndarray, factor: float) -> np.ndarray:
    """== :func:`adjust_brightness` (ImageEnhance.Brightness degenerate is
    black), applied as one LUT take instead of a PIL round trip (C kernel
    when built, csrc fd_lut_u8; numpy take otherwise)."""
    from fastdepth_tpu_torch.data import native

    return native.lut_u8(img, _blend_lut((0, 0, 0), factor))


def adjust_contrast_fast(img: np.ndarray, factor: float) -> np.ndarray:
    """== :func:`adjust_contrast`: degenerate is a solid gray at
    ``int(mean(L) + 0.5)`` (PIL ImageEnhance.Contrast).  The L plane uses
    Pillow's own fixed-point coefficients (native.l_mean_rounded,
    sweep-verified against ``convert('L')`` in tests/test_native.py so a
    Pillow coefficient change would be caught, not silently diverged
    from); the mean over the uint8 L plane is integer-exact in
    float64."""
    from fastdepth_tpu_torch.data import native

    l_mean = native.l_mean_rounded(img)
    return native.lut_u8(img, _blend_lut((l_mean, l_mean, l_mean), factor))


def adjust_saturation_fast(img: np.ndarray, factor: float) -> np.ndarray:
    """== :func:`adjust_saturation` (ImageEnhance.Color: blend toward the
    per-pixel 'L' gray).  The degenerate is per-pixel so no 1-D LUT
    exists; the C kernel (csrc fd_blend_gray_u8) replicates PIL's
    float32 truncate-then-clip blend bit-exactly (grid-swept in
    tests/test_native.py).  Without the built library this stays
    PIL-direct — the numpy fancy-index form measured slower than PIL's C
    blend (docs/kernel_notes.md)."""
    from fastdepth_tpu_torch.data import native

    if native.available():
        return native.blend_gray_u8(img, factor)
    return adjust_saturation(img, factor)


class ColorJitter:
    """Random brightness/contrast/saturation/hue in random order
    (reference transforms.py:513-578; NYU uses (0.4, 0.4, 0.4),
    dataloader.py:46).  Takes an explicit RandomState for determinism.

    Brightness/contrast apply as ``*_fast`` LUT forms — bit-identical to
    the PIL-direct ``adjust_*`` functions (the LUTs are built by PIL
    itself; equality is sweep-tested) at ~2x less per-item cost
    (docs/kernel_notes.md, host-pipeline section)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    # op-kind codes shared with the device-side jitter
    # (data/device_aug.py KIND_*); hue has no device kernel (NYU uses
    # hue=0) and is rejected by the device path at dataset setup
    BRIGHTNESS, CONTRAST, SATURATION, HUE = 1, 2, 3, 4

    def draw_plan(self, rng: np.random.RandomState):
        """Draw the item's (kind, factor) op sequence WITHOUT applying —
        the factor draws (ordered b/c/s/h, only for >0 settings) and the
        order shuffle consume exactly the same rng state as application,
        so host apply and device apply see identical plans (reference
        transforms.py:513-578 protocol: np.random.uniform per enabled op
        then np.random.shuffle)."""
        ops = []
        if self.brightness > 0:
            ops.append((self.BRIGHTNESS, float(rng.uniform(
                max(0, 1 - self.brightness), 1 + self.brightness))))
        if self.contrast > 0:
            ops.append((self.CONTRAST, float(rng.uniform(
                max(0, 1 - self.contrast), 1 + self.contrast))))
        if self.saturation > 0:
            ops.append((self.SATURATION, float(rng.uniform(
                max(0, 1 - self.saturation), 1 + self.saturation))))
        if self.hue > 0:
            ops.append((self.HUE, float(rng.uniform(-self.hue, self.hue))))
        rng.shuffle(ops)
        return ops

    _APPLY = {
        BRIGHTNESS: adjust_brightness_fast,
        CONTRAST: adjust_contrast_fast,
        SATURATION: adjust_saturation_fast,
        HUE: adjust_hue,
    }

    def __call__(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        for kind, f in self.draw_plan(rng):
            img = self._APPLY[kind](img, f)
        return img
