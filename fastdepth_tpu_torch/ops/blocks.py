"""Functional ops on tensors — counterpart of ``fastdepth_tpu/ops/blocks.py``.

Inside the port, activations are logical NCHW tensors stored
``torch.channels_last`` (NHWC memory, what cuDNN's fast convolutions and
the CUDA kernels read) and conv weights are OIHW.  The public forwards
keep the JAX package's NHWC layout at their edges (:func:`from_nhwc`,
:func:`to_nhwc`).  JAX left every op here to XLA; the port leaves them
to PyTorch (cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, used throughout the reference


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Public NHWC ``(N, H, W, C)`` -> the port's channels_last NCHW
    (a view when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Channels_last NCHW -> public NHWC (a view)."""
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: Optional[int] = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2-D convolution, OIHW weights.  ``padding=None`` means torch-style
    "same for odd kernels": p = (k - 1) // 2 on both sides."""
    k = w.shape[-1]
    return F.conv2d(x, w, bias, stride=stride,
                    padding=(k - 1) // 2 if padding is None else padding)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: Optional[int] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise conv: w is ``(C, 1, k, k)`` and groups == C."""
    k = w.shape[-1]
    return F.conv2d(x, w, bias, stride=stride,
                    padding=(k - 1) // 2 if padding is None else padding,
                    groups=x.shape[1])


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def batch_norm(x: torch.Tensor, bn, *, eps: float = BN_EPS) -> torch.Tensor:
    """Inference-mode BatchNorm (running statistics); ``bn`` carries
    ``scale``, ``bias``, ``mean`` and ``var``."""
    inv = torch.rsqrt(bn.var + eps) * bn.scale
    return x * _per_channel(inv) + _per_channel(bn.bias - bn.mean * inv)


def batch_norm_train(x: torch.Tensor, bn, *, eps: float = BN_EPS,
                     momentum: float = 0.1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training-mode BatchNorm over (N, H, W); returns the output and the
    new running statistics ``{'mean', 'var'}`` (torch's convention: new =
    (1 - m) * old + m * batch, the variance unbiased), which the caller
    merges: ``bn``'s buffers are never written here (``F.batch_norm``
    updates copies of them), so a forward run twice
    (``torch.utils.checkpoint``) or a skipped step leaves them as they
    were.

    One ``F.batch_norm`` call (cuDNN's on the card): a bf16 ``x`` with
    ``bn``'s f32 parameters takes PyTorch's mixed-precision path, which
    accumulates the moments in f32 and returns bf16.  It needs more than
    one value a channel (N * H * W > 1), as torch's BatchNorm2d does."""
    mean, var = bn.mean.clone(), bn.var.clone()
    y = F.batch_norm(x, mean, var, bn.scale, bn.bias, training=True, momentum=momentum,
                     eps=eps)
    return y, {"mean": mean, "var": var}


def fold_bn(w: torch.Tensor, bn, *, eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into the preceding OIHW conv (dense or
    depthwise: the BN axis is O either way).  Returns (w', b') with
    conv(x, w') + b' == bn(conv(x, w))."""
    inv = 1.0 / torch.sqrt(bn.var + eps) * bn.scale
    return w * inv.reshape(-1, 1, 1, 1), bn.bias - bn.mean * inv


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (reference models.py:722-723): each pixel
    becomes a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
