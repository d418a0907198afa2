"""Parameter leaves and the conv(+BN) composite — counterpart of
``fastdepth_tpu/models/layers.py``.

A model's parameters are an ``nn.ModuleDict`` tree shaped like the JAX
package's npz tree, so the state-dict key of every array is its npz key
with ``/`` replaced by ``.`` (``encoder.conv3.dw.w``,
``decoder.decode_conv2.pw.bn.scale``).  Each conv leaf is a
:class:`ConvBN` holding either an unfolded ``bn`` or a folded bias ``b``,
the npz ``{'w','bn'}`` / ``{'w','b'}`` pair.  The math is a plain
function, :func:`apply_conv_bn`.  This slice is inference only: no
parameter takes a gradient.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from fastdepth_tpu_torch.ops import blocks as B


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class BatchNorm(nn.Module):
    """Inference BatchNorm statistics, named like the npz leaves."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = _frozen(torch.ones(c))
        self.bias = _frozen(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ConvBN(nn.Module):
    """One conv leaf: OIHW ``w`` and either ``bn`` (unfolded) or ``b``
    (folded)."""

    def __init__(self, w: torch.Tensor, *, b: Optional[torch.Tensor] = None,
                 bn: Optional[BatchNorm] = None):
        super().__init__()
        if (b is None) == (bn is None):
            raise ValueError("a conv leaf holds exactly one of b (folded) or bn")
        self.w = _frozen(w)
        self.b = None if b is None else _frozen(b)
        self.bn = bn


def conv_leaf(w_shape: Sequence[int], *, folded: bool) -> ConvBN:
    """A zero-filled leaf of the given OIHW shape, to be loaded from a
    state dict."""
    cout = w_shape[0]
    w = torch.zeros(tuple(w_shape))
    if folded:
        return ConvBN(w, b=torch.zeros(cout))
    return ConvBN(w, bn=BatchNorm(cout))


def apply_conv_bn(x: torch.Tensor, p: ConvBN, *, stride: int = 1,
                  act: Optional[Callable] = B.relu, depthwise: bool = False) -> torch.Tensor:
    """conv (+ folded bias) -> [BN] -> [act], the eval path of the JAX
    ``apply_conv_bn``."""
    conv = B.depthwise_conv2d if depthwise else B.conv2d
    y = conv(x, p.w, stride=stride, bias=p.b)
    if p.bn is not None:
        y = B.batch_norm(y, p.bn)
    return act(y) if act is not None else y


def fold_params(p: ConvBN) -> ConvBN:
    """Fold ``bn`` into ``(w, b)``; an already-folded leaf passes through."""
    if p.bn is None:
        return p
    w, b = B.fold_bn(p.w, p.bn)
    return ConvBN(w, b=b)


def tree_fold(params: nn.Module) -> nn.Module:
    """A copy of ``params`` with every BatchNorm folded into its conv."""
    out = copy.deepcopy(params)
    unfolded = [(parent, name) for parent in out.modules()
                for name, child in parent.named_children()
                if isinstance(child, ConvBN) and child.bn is not None]
    for parent, name in unfolded:
        setattr(parent, name, fold_params(getattr(parent, name)))
    return out
