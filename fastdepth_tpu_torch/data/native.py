"""ctypes bindings for the native preprocessing kernels
(``fastdepth_tpu_torch/csrc/preprocess.cpp``) — the port's copy of
``fastdepth_tpu/data/native.py``.

The library is built at first use (``ops/cuda/_build.build_native``, g++
into the gitignored ``_build/``).  Falls back to numpy transparently when
it cannot be built — the numpy path is semantically identical (same
gather indices), just slower per item.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _find_lib() -> Optional[str]:
    from fastdepth_tpu_torch.ops.cuda import _build

    try:
        return _build.build_native()
    except (OSError, RuntimeError):
        return None


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    # ABI handshake: a stale locally-built .so (or one missing the version
    # symbol entirely) silently diverging from preprocess.cpp is worse than
    # the numpy fallback — refuse it.
    try:
        lib.fd_abi_version.restype = ctypes.c_int64
        if lib.fd_abi_version() != 4:
            return None
    except AttributeError:
        return None
    i64 = ctypes.c_int64
    f32 = ctypes.c_float
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fd_gather_rgb_f32.argtypes = [u8p, i64, i64, i64p, i64p, i64, i64, f32p]
    lib.fd_gather_depth_f32.argtypes = [f32p, i64, i64, i64p, i64p, i64, i64, f32p]
    lib.fd_chw_to_hwc_u8.argtypes = [u8p, i64, i64, u8p]
    lib.fd_train_gather.argtypes = [u8p, f32p, i64p, u8p, i64, f32, u8p, f32p]
    lib.fd_lut_u8.argtypes = [u8p, i64, u8p, u8p]
    lib.fd_l_sum.argtypes = [u8p, i64]
    lib.fd_l_sum.restype = ctypes.c_int64
    lib.fd_blend_gray_u8.argtypes = [u8p, i64, f32, u8p]
    lib.fd_u8_to_unit_f32.argtypes = [u8p, i64, f32p]
    lib.fd_blend_grid.argtypes = [f32, u8p]
    for fn in (lib.fd_gather_rgb_f32, lib.fd_gather_depth_f32,
               lib.fd_chw_to_hwc_u8, lib.fd_train_gather, lib.fd_lut_u8,
               lib.fd_blend_gray_u8, lib.fd_u8_to_unit_f32):
        fn.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gather_rgb_f32(rgb: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """uint8 HWC + index maps -> float32 HWC in [0, 1]."""
    lib = load_library()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if rgb.dtype != np.uint8:
        raise ValueError(
            f"gather_rgb_f32 takes raw uint8 HWC rgb, got {rgb.dtype} "
            "(a float buffer would be reinterpreted byte-wise by the C "
            "kernel)")
    if lib is None:
        return (rgb[rows][:, cols].astype(np.float32)) / 255.0
    rgb = np.ascontiguousarray(rgb)
    out = np.empty((len(rows), len(cols), 3), np.float32)
    lib.fd_gather_rgb_f32(
        _ptr(rgb, ctypes.c_uint8), rgb.shape[0], rgb.shape[1],
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        len(rows), len(cols), _ptr(out, ctypes.c_float),
    )
    return out


def gather_depth_f32(depth: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    lib = load_library()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    depth = np.ascontiguousarray(depth, np.float32)
    if lib is None:
        return depth[rows][:, cols]
    out = np.empty((len(rows), len(cols)), np.float32)
    lib.fd_gather_depth_f32(
        _ptr(depth, ctypes.c_float), depth.shape[0], depth.shape[1],
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        len(rows), len(cols), _ptr(out, ctypes.c_float),
    )
    return out


# PIL convert('L') fixed-point coefficients (Pillow's L24 macro); the
# numpy fallbacks below use them directly and tests/test_native.py
# sweep-verifies both paths against Pillow itself.
_L_R, _L_G, _L_B, _L_HALF = 19595, 38470, 7471, 0x8000


def _l_plane(img: np.ndarray) -> np.ndarray:
    """PIL 'L' conversion of an (..., 3) uint8 image, as int32."""
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    return ((r * _L_R + g * _L_G + b * _L_B + _L_HALF) >> 16).astype(np.int32)


def train_gather(
    rgb: np.ndarray,
    depth: np.ndarray,
    flat: np.ndarray,
    mask: np.ndarray,
    scale: float,
) -> tuple:
    """Fused train-item geometry (reference nyu.py:26-41 composed into one
    raw->output map, data/pipeline.py::composed_indices): gather the raw
    uint8 HWC rgb and float32 depth through ``flat``, zero the rotation's
    pad ``mask``, and DIVIDE depth by ``scale`` (nyu.py:28, depth /= s) —
    float32 division in both paths, so native == numpy bit-exactly.
    Returns (rgb_u8, depth_f32) shaped like ``flat``(+channels)."""
    lib = load_library()
    if rgb.dtype != np.uint8 or rgb.shape[-1] != 3:
        raise ValueError(
            f"train_gather takes raw uint8 HWC rgb, got {rgb.dtype} "
            f"{rgb.shape}")
    flat = np.ascontiguousarray(flat, np.int64)
    out_shape = flat.shape
    if lib is None:
        rgb_out = rgb.reshape(-1, 3)[flat]
        rgb_out[mask] = 0
        depth_out = (
            depth.reshape(-1)[flat].astype(np.float32) / np.float32(scale))
        depth_out[mask] = 0.0
        return rgb_out, depth_out
    rgb = np.ascontiguousarray(rgb)
    depth = np.ascontiguousarray(depth, np.float32)
    mask_u8 = np.ascontiguousarray(mask, np.uint8)
    rgb_out = np.empty(out_shape + (3,), np.uint8)
    depth_out = np.empty(out_shape, np.float32)
    lib.fd_train_gather(
        _ptr(rgb, ctypes.c_uint8), _ptr(depth, ctypes.c_float),
        _ptr(flat, ctypes.c_int64), _ptr(mask_u8, ctypes.c_uint8),
        flat.size, ctypes.c_float(scale),
        _ptr(rgb_out, ctypes.c_uint8), _ptr(depth_out, ctypes.c_float),
    )
    return rgb_out, depth_out


def lut_u8(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """256-entry value-map apply (PIL enhance LUTs built by
    transforms._blend_lut)."""
    if img.dtype != np.uint8 or lut.dtype != np.uint8 or lut.size != 256:
        raise ValueError(
            f"lut_u8 takes uint8 img + 256-entry uint8 lut, got "
            f"{img.dtype}/{lut.dtype}[{lut.size}]")
    lib = load_library()
    if lib is None:
        return lut[img]
    img = np.ascontiguousarray(img)
    lut = np.ascontiguousarray(lut)
    out = np.empty_like(img)
    lib.fd_lut_u8(_ptr(img, ctypes.c_uint8), img.size,
                  _ptr(lut, ctypes.c_uint8), _ptr(out, ctypes.c_uint8))
    return out


def l_mean_rounded(img: np.ndarray) -> int:
    """``int(mean(PIL L plane) + 0.5)`` — ImageEnhance.Contrast's
    degenerate gray level (the sum is exact in int64; the mean stays
    exact in float64 for any realistic image size)."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"l_mean_rounded takes uint8 RGB, got {img.dtype}")
    n = img.size // 3
    lib = load_library()
    if lib is None:
        s = int(_l_plane(img).astype(np.int64).sum())
    else:
        img = np.ascontiguousarray(img)
        s = int(lib.fd_l_sum(_ptr(img, ctypes.c_uint8), n))
    return int(s / n + 0.5)


def blend_gray_u8(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Color (saturation): blend each pixel toward its
    own 'L' gray; PIL's exact float32 truncate-then-clip arithmetic."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"blend_gray_u8 takes uint8 RGB, got {img.dtype}")
    lib = load_library()
    if lib is None:
        g = _l_plane(img).astype(np.float32)[..., None]
        t = g + np.float32(factor) * (img.astype(np.float32) - g)
        return np.clip(np.trunc(t), 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    out = np.empty_like(img)
    lib.fd_blend_gray_u8(_ptr(img, ctypes.c_uint8), img.size // 3,
                         ctypes.c_float(factor), _ptr(out, ctypes.c_uint8))
    return out


def u8_to_unit_f32(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] (the /255 at reference nyu.py:43)."""
    if img.dtype != np.uint8:
        raise ValueError(f"u8_to_unit_f32 takes uint8, got {img.dtype}")
    lib = load_library()
    if lib is None:
        return img.astype(np.float32) / 255.0
    img = np.ascontiguousarray(img)
    out = np.empty(img.shape, np.float32)
    lib.fd_u8_to_unit_f32(_ptr(img, ctypes.c_uint8), img.size,
                          _ptr(out, ctypes.c_float))
    return out


def blend_grid(factor: float) -> Optional[np.ndarray]:
    """(256, 256) uint8 PIL-blend value grid ``grid[d, v] =
    pil_blend(d, v, factor)`` — the device-jitter table bake
    (transforms.blend_grid owns the numpy form and the docs; this is its
    C kernel, ~5x faster, bit-identical: same stepwise f32 with
    -ffp-contract=off).  None when the native lib is absent (the caller
    falls back to the numpy bake)."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((256, 256), np.uint8)
    lib.fd_blend_grid(ctypes.c_float(factor), _ptr(out, ctypes.c_uint8))
    return out


def chw_to_hwc_u8(chw: np.ndarray) -> np.ndarray:
    if chw.dtype != np.uint8:
        raise ValueError(f"chw_to_hwc_u8 takes uint8, got {chw.dtype}")
    lib = load_library()
    if lib is None:
        return np.transpose(chw, (1, 2, 0)).copy()
    chw = np.ascontiguousarray(chw)
    h, w = chw.shape[1], chw.shape[2]
    out = np.empty((h, w, 3), np.uint8)
    lib.fd_chw_to_hwc_u8(_ptr(chw, ctypes.c_uint8), h, w, _ptr(out, ctypes.c_uint8))
    return out
