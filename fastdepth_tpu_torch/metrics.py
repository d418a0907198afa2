"""Depth metrics, exact reference semantics (reference metrics.py:9-95) —
counterpart of ``fastdepth_tpu/metrics.py``, re-implemented because that
module imports JAX.

Reproduced precisely — do not "fix" these for parity's sake:

* validity mask is the **union** ``(target > 0) | (output > 0)``,
* depths are scaled x1e3 into **millimeters** before every metric,
* delta_k = mean(max(out/tgt, tgt/out) < 1.25^k),
* iRMSE/iMAE on inverse depth,
* per-image metrics, count-weight-averaged across images (AverageMeter).

:func:`evaluate_batch` computes all 10 metrics for a whole batch on the
device in one pass of masked sums (no boolean indexing), so only 10
scalars per image leave the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

METRIC_FIELDS = (
    "irmse", "imae", "mse", "rmse", "mae", "absrel", "lg10",
    "delta1", "delta2", "delta3",
)


@dataclasses.dataclass
class Result:
    """One evaluation record (reference metrics.py:9-29)."""

    irmse: float = 0.0
    imae: float = 0.0
    mse: float = 0.0
    rmse: float = 0.0
    mae: float = 0.0
    absrel: float = 0.0
    lg10: float = 0.0
    delta1: float = 0.0
    delta2: float = 0.0
    delta3: float = 0.0
    data_time: float = 0.0
    gpu_time: float = 0.0

    def set_to_worst(self) -> "Result":
        for f in ("irmse", "imae", "mse", "rmse", "mae", "absrel", "lg10"):
            setattr(self, f, float("inf"))
        self.delta1 = self.delta2 = self.delta3 = 0.0
        self.data_time = self.gpu_time = 0.0
        return self

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, x.dim()))
    return torch.where(mask, x, 0.0).sum(dim=dims) / mask.sum(dim=dims)


def evaluate_batch(output: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All metrics for an (N, H, W, 1) batch, per image, on its device.

    Returns a dict of (N,)-vectors in float32, matching the reference's
    ``Result.evaluate`` per image: union mask, millimeter scaling, each
    mean over that image's valid pixels only."""
    output = output.float()
    target = target.float()
    mask = (target > 0) | (output > 0)
    out_mm = 1e3 * output
    tgt_mm = 1e3 * target

    abs_diff = (out_mm - tgt_mm).abs()
    mse = _masked_mean(abs_diff * abs_diff, mask)
    mae = _masked_mean(abs_diff, mask)
    # log10 / ratios are only evaluated on masked pixels; `where` keeps the
    # computation NaN-free for excluded pixels (the reference's boolean
    # indexing never sees them)
    safe_out = torch.where(mask, out_mm, 1.0)
    safe_tgt = torch.where(mask, tgt_mm, 1.0)
    lg10 = _masked_mean((torch.log10(safe_out) - torch.log10(safe_tgt)).abs(), mask)
    absrel = _masked_mean(abs_diff / safe_tgt, mask)

    max_ratio = torch.maximum(safe_out / safe_tgt, safe_tgt / safe_out)
    deltas = {f"delta{k}": _masked_mean((max_ratio < 1.25 ** k).float(), mask)
              for k in (1, 2, 3)}

    inv_diff = (1.0 / safe_out - 1.0 / safe_tgt).abs()
    return {
        "irmse": torch.sqrt(_masked_mean(inv_diff * inv_diff, mask)),
        "imae": _masked_mean(inv_diff, mask),
        "mse": mse,
        "rmse": torch.sqrt(mse),
        "mae": mae,
        "absrel": absrel,
        "lg10": lg10,
        **deltas,
    }


class AverageMeter:
    """Count-weighted running average (reference metrics.py:58-95)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0.0
        self.sums = {f: 0.0 for f in METRIC_FIELDS}
        self.sum_data_time = 0.0
        self.sum_gpu_time = 0.0

    def update(self, result, gpu_time: float = 0.0, data_time: float = 0.0, n: int = 1):
        self.count += n
        vals = result.as_dict() if isinstance(result, Result) else result
        for f in METRIC_FIELDS:
            self.sums[f] += n * float(vals[f])
        self.sum_data_time += n * data_time
        self.sum_gpu_time += n * gpu_time

    def update_batch(self, metrics: Dict[str, np.ndarray], gpu_time: float = 0.0,
                     data_time: float = 0.0):
        """Fold in per-image metric vectors (host arrays) from
        :func:`evaluate_batch`."""
        vals = {k: np.asarray(v) for k, v in metrics.items()}
        n = len(next(iter(vals.values())))
        self.count += n
        for f in METRIC_FIELDS:
            self.sums[f] += float(vals[f].sum())
        self.sum_data_time += n * data_time
        self.sum_gpu_time += n * gpu_time

    def average(self) -> Result:
        c = self.count
        return Result(
            **{f: self.sums[f] / c for f in METRIC_FIELDS},
            data_time=self.sum_data_time / c,
            gpu_time=self.sum_gpu_time / c,
        )
