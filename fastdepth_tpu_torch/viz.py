"""Visualization: viridis depth colormaps and rgb|gt|pred comparison
strips (reference utils.py:37-83 and deploy/data/visualize.py:9-35) —
the port's copy of ``fastdepth_tpu/viz.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np


def viridis(x: np.ndarray) -> np.ndarray:
    """``matplotlib.pyplot.cm.viridis(x)[..., :3]`` for a float array,
    without matplotlib: the same 256-entry table (``viridis.py``) and
    matplotlib's index rule — ``x * 256`` in ``x``'s own dtype, 1.0 on
    the last entry, truncated; below 0 the first entry, 1 and above the
    last, NaN black."""
    from fastdepth_tpu_torch.viridis import VIRIDIS_DATA

    n = len(VIRIDIS_DATA)
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over] = 0, n - 1
    out = np.asarray(VIRIDIS_DATA, dtype=float)[np.clip(idx, 0, n - 1)]
    out[bad] = 0.0
    return out


def colored_depthmap(depth: np.ndarray, d_min: Optional[float] = None,
                     d_max: Optional[float] = None) -> np.ndarray:
    """Depth (H, W) -> viridis RGB float in [0, 255] (utils.py:37-43)."""
    if d_min is None:
        d_min = float(np.min(depth))
    if d_max is None:
        d_max = float(np.max(depth))
    span = d_max - d_min
    # constant map (untrained model, zero pred): 0/0 would paint NaNs
    rel = (depth - d_min) / span if span > 0 else np.zeros_like(depth)
    return 255 * viridis(rel)


def merge_into_row(rgb: np.ndarray, depth_target: np.ndarray,
                   depth_pred: np.ndarray) -> np.ndarray:
    """One comparison row [rgb | gt | pred] with a shared color scale
    (utils.py:46-57).  Inputs NHWC/HWC rgb in [0, 1] float or uint8, and
    (H, W[,1]) depths."""
    rgb = np.squeeze(np.asarray(rgb))
    rgb = rgb.astype(np.float64) if rgb.dtype == np.uint8 else 255 * rgb
    tgt = np.squeeze(np.asarray(depth_target))
    pred = np.squeeze(np.asarray(depth_pred))
    d_min = min(float(tgt.min()), float(pred.min()))
    d_max = max(float(tgt.max()), float(pred.max()))
    return np.hstack([
        rgb,
        colored_depthmap(tgt, d_min, d_max),
        colored_depthmap(pred, d_min, d_max),
    ])


def merge_into_row_with_gt(rgb: np.ndarray, depth_input: np.ndarray,
                           depth_target: np.ndarray,
                           depth_pred: np.ndarray) -> np.ndarray:
    """[rgb | input depth | gt | pred] strip (utils.py:60-74)."""
    rgb = np.squeeze(np.asarray(rgb))
    rgb = rgb.astype(np.float64) if rgb.dtype == np.uint8 else 255 * rgb
    din = np.squeeze(np.asarray(depth_input))
    tgt = np.squeeze(np.asarray(depth_target))
    pred = np.squeeze(np.asarray(depth_pred))
    d_min = min(float(din.min()), float(tgt.min()), float(pred.min()))
    d_max = max(float(din.max()), float(tgt.max()), float(pred.max()))
    return np.hstack([
        rgb,
        colored_depthmap(din, d_min, d_max),
        colored_depthmap(tgt, d_min, d_max),
        colored_depthmap(pred, d_min, d_max),
    ])


def add_row(img_merge: np.ndarray, row: np.ndarray) -> np.ndarray:
    return np.vstack([img_merge, row])


def save_image(img_merge: np.ndarray, filename: str) -> None:
    from PIL import Image

    Image.fromarray(img_merge.astype("uint8")).save(filename)
