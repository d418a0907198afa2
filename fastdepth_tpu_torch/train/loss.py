"""Depth losses — counterpart of ``fastdepth_tpu/train/loss.py``.

The public reference release is eval-only, but FastDepth trains with an
L1 loss on valid pixels (paper recipe; BASELINE.json config #5 names the
loss).
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 over pixels with valid ground truth (target > 0): rotation
    padding and Kinect holes carry depth 0 and must not train the net."""
    mask = target > 0
    diff = torch.where(mask, torch.abs(pred - target), 0.0)
    return torch.sum(diff) / torch.clamp(torch.sum(mask), min=1)
