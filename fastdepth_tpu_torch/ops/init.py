"""Weight initialization — counterpart of ``fastdepth_tpu/ops/init.py``,
matching the reference's ``weights_init`` (reference models.py:36-50):

* Conv2d (dense or depthwise, OIHW): N(0, sqrt(2 / (k^2 * C_out)));
  torch sees a depthwise layer as Conv2d(C, C, k, groups=C), so its n is
  k^2 * C, the same formula with C_out = C;
* BatchNorm2d: scale 1, bias 0, running mean 0, var 1.

Random numbers come from an explicit ``torch.Generator``; JAX keys give
other numbers from the same seed, so the tests compare distributions and
shapes, not values.  The ConvTranspose2d rule (n = k^2 * C_in) comes with
the deconv decoders (ROADMAP A11).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fastdepth_tpu_torch.models import layers as L


def he_normal_conv(shape, generator: torch.Generator) -> torch.Tensor:
    """An OIHW conv weight (dense ``(Cout, Cin, kh, kw)`` or depthwise
    ``(C, 1, kh, kw)``) drawn from N(0, sqrt(2 / (kh * kw * O)))."""
    cout, _, kh, kw = shape
    std = math.sqrt(2.0 / (kh * kw * cout))
    return torch.randn(tuple(shape), generator=generator) * std


def init_tree(params: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every conv leaf of an unfolded tree in place: He-normal ``w``
    (in module order), BatchNorm at its defaults.  Returns ``params``."""
    for m in params.modules():
        if isinstance(m, L.ConvBN):
            if m.bn is None:
                raise ValueError("init fills unfolded trees ({'w','bn'} leaves)")
            m.w.data = he_normal_conv(m.w.shape, generator)
            m.bn.scale.data.fill_(1.0)
            m.bn.bias.data.zero_()
            m.bn.mean.fill_(0.0)
            m.bn.var.fill_(1.0)
    return params
