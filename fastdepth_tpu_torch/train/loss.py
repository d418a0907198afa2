"""Depth losses — counterpart of ``fastdepth_tpu/train/loss.py``.

The public reference release is eval-only, but FastDepth trains with an
L1 loss on valid pixels (paper recipe; BASELINE.json config #5 names the
loss).

Under a data mesh (``group``: its process group) each rank holds a share
of the global batch, and each returns its share of the GLOBAL loss: its
own sum over the global denominator.  The trainer's one all-reduce of
the gradient (and of these shares) then gives the loss and gradient of
the whole batch, as the JAX package's mesh step computes them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def l1_loss(pred: torch.Tensor, target: torch.Tensor, group=None) -> torch.Tensor:
    if group is None:
        return torch.mean(torch.abs(pred - target))
    return torch.sum(torch.abs(pred - target)) / (pred.numel() * dist.get_world_size(group))


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor, group=None) -> torch.Tensor:
    """L1 over pixels with valid ground truth (target > 0): rotation
    padding and Kinect holes carry depth 0 and must not train the net.
    With ``group``, the valid count is all-reduced (it takes no
    gradient)."""
    mask = target > 0
    diff = torch.where(mask, torch.abs(pred - target), 0.0)
    count = torch.sum(mask)
    if group is not None:
        count = count.contiguous().clone()
        dist.all_reduce(count, group=group)
    return torch.sum(diff) / torch.clamp(count, min=1)
