"""Weight initialization — counterpart of ``fastdepth_tpu/ops/init.py``,
matching the reference's ``weights_init`` (reference models.py:36-50):

* Conv2d (dense or depthwise, OIHW): N(0, sqrt(2 / (k^2 * C_out)));
  torch sees a depthwise layer as Conv2d(C, C, k, groups=C), so its n is
  k^2 * C, the same formula with C_out = C;
* ConvTranspose2d (``(Cin, Cout / groups, k, k)``): N(0, sqrt(2 / (k^2 *
  C_in))), which :func:`he_normal_conv` draws from the same ``shape[0]``;
* a conv leaf with a bias and no BatchNorm (ResNet's ``conv2``): He
  normal ``w`` and a zero bias (weights_init zeroes every conv bias);
* BatchNorm2d: scale 1, bias 0, running mean 0, var 1;
* the ImageNet classifier's Linear (:func:`uniform_linear`): torch's
  default U(-1/sqrt(features), 1/sqrt(features)) for weight and bias.

The BN-free DINOv2 + DPT family has its own init
(``models/dinov2_dpt.init_dinov2_dpt``: DINOv2's, with
:func:`trunc_normal` and these convs).

Random numbers come from an explicit ``torch.Generator``; JAX keys give
other numbers from the same seed, so the tests compare distributions and
shapes, not values.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fastdepth_tpu_torch.models import layers as L


def he_normal_conv(shape, generator: torch.Generator) -> torch.Tensor:
    """A conv weight drawn from N(0, sqrt(2 / (kh * kw * shape[0]))).

    For an OIHW weight (dense ``(Cout, Cin, kh, kw)`` or depthwise ``(C,
    1, kh, kw)``) ``shape[0]`` is C_out, the Conv2d rule.  For a
    transposed conv's ``(Cin, Cout / groups, kh, kw)`` it is C_in, which
    is the ConvTranspose2d rule (n = k^2 * C_in, reference
    models.py:43-47): one formula serves both layouts."""
    n0, _, kh, kw = shape
    std = math.sqrt(2.0 / (kh * kw * n0))
    return torch.randn(tuple(shape), generator=generator) * std


def trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std) cut at +-2 (absolute, timm's ``trunc_normal_`` defaults,
    which DINOv2 calls with ``std=0.02``)."""
    return nn.init.trunc_normal_(torch.empty(tuple(shape)), std=std, generator=generator)


def uniform_linear(features: int, classes: int, generator: torch.Generator):
    """``(w (features, classes), b (classes,))`` from U(-1/sqrt(features),
    1/sqrt(features)), torch Linear's default (the JAX
    ``init_classifier``)."""
    bound = 1.0 / math.sqrt(features)

    def draw(*shape):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    return draw(features, classes), draw(classes)


def init_tree(params: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every conv leaf of an unfolded tree in place, in module order:
    He-normal ``w`` (its layout's rule), a zero bias ``b`` where the leaf
    has one (no BatchNorm follows it), BatchNorm at its defaults.  A tree
    with no BatchNorm left is a folded one, and is refused.  Returns
    ``params``."""
    if not any(isinstance(m, L.BatchNorm) for m in params.modules()):
        raise ValueError("init fills unfolded trees ({'w','bn'} leaves); this one is folded")
    for m in params.modules():
        if isinstance(m, L.ConvBN):
            m.w.data = he_normal_conv(m.w.shape, generator)
            if m.b is not None:
                m.b.data.zero_()
            if m.bn is not None:
                m.bn.scale.data.fill_(1.0)
                m.bn.bias.data.zero_()
                m.bn.mean.fill_(0.0)
                m.bn.var.fill_(1.0)
    return params
