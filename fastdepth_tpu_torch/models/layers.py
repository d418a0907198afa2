"""Parameter leaves and the conv(+BN) composite — counterpart of
``fastdepth_tpu/models/layers.py``.

A model's parameters are an ``nn.ModuleDict`` tree shaped like the JAX
package's npz tree, so the state-dict key of every array is its npz key
with ``/`` replaced by ``.`` (``encoder.conv3.dw.w``,
``decoder.decode_conv2.pw.bn.scale``).  Each conv leaf is a
:class:`ConvBN` holding either an unfolded ``bn`` or a folded bias ``b``,
the npz ``{'w','bn'}`` / ``{'w','b'}`` pair.  The math is a plain
function, :func:`apply_conv_bn`.

``w``, ``b``, ``bn.scale`` and ``bn.bias`` are ``nn.Parameter`` s and
``bn.mean`` / ``bn.var`` buffers, as in a torch ``BatchNorm2d``.  The
parameters come frozen (``Model.load`` and ``Model.init`` give inference
trees); ``train.trainer.sgd_init`` turns their gradients on.  In training
mode :func:`apply_conv_bn` records each BatchNorm's new running
statistics into a ``stats`` dict keyed by its path (a tuple of names)
and writes no buffer; the caller merges them (:func:`merge_stats`; the
trainer writes them into its flat buffer of running statistics).  A
folded tree is for inference: its leaves stay frozen.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, MutableMapping, Optional, Sequence, Tuple

import torch
from torch import nn

from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.parallel import spatial as S


StatsDict = MutableMapping[Tuple[str, ...], Dict[str, torch.Tensor]]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter with its gradient off until a trainer turns it on."""
    return nn.Parameter(t, requires_grad=False)


class BatchNorm(nn.Module):
    """BatchNorm's parameters (``scale``, ``bias``) and running statistics
    (the ``mean`` / ``var`` buffers), named like the npz leaves."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = _frozen(torch.ones(c))
        self.bias = _frozen(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ConvBN(nn.Module):
    """One conv leaf: ``w`` and either ``bn`` (unfolded) or ``b`` (folded,
    or a conv with a bias and no BatchNorm, such as ResNet's ``conv2``).
    ``w`` is OIHW, or with ``transpose`` a transposed conv's ``(Cin, Cout
    / groups, kh, kw)``: the leaf carries that so that folding scales the
    right axis (the JAX package's ``transpose_keys``)."""

    def __init__(self, w: torch.Tensor, *, b: Optional[torch.Tensor] = None,
                 bn: Optional[BatchNorm] = None, transpose: bool = False):
        super().__init__()
        if (b is None) == (bn is None):
            raise ValueError("a conv leaf holds exactly one of b (folded) or bn")
        self.w = _frozen(w)
        self.b = None if b is None else _frozen(b)
        self.bn = bn
        self.transpose = transpose


class Linear(nn.Module):
    """A dense leaf ``{'w': (features, classes), 'b': (classes,)}``, the
    ImageNet classifier's ``fc``, computed ``x @ w + b`` as in JAX."""

    def __init__(self, features: int, classes: int):
        super().__init__()
        self.w = _frozen(torch.zeros(features, classes))
        self.b = _frozen(torch.zeros(classes))


def conv_leaf(w_shape: Sequence[int], *, folded: bool, transpose: bool = False,
              groups: int = 1) -> ConvBN:
    """A zero-filled leaf of the given weight shape, to be loaded from a
    state dict: OIHW, or with ``transpose`` ``(Cin, Cout / groups, kh,
    kw)``.  ``folded`` gives ``{'w','b'}`` (also the form of a conv with a
    bias and no BatchNorm), else ``{'w','bn'}``."""
    cout = w_shape[1] * groups if transpose else w_shape[0]
    w = torch.zeros(tuple(w_shape))
    if folded:
        return ConvBN(w, b=torch.zeros(cout), transpose=transpose)
    return ConvBN(w, bn=BatchNorm(cout), transpose=transpose)


class TrainStats(dict):
    """The ``stats`` recorder of a train-mode forward over a data mesh: a
    dict like any other, which also names the process group its BatchNorms
    take the global batch's moments over (``ops.blocks.batch_norm_train``).
    The trainer makes one per forward, so a forward run again under
    ``remat`` issues the same collectives on every rank."""

    def __init__(self, group=None):
        super().__init__()
        self.group = group


def sub_stats(stats: Optional[StatsDict], prefix: str) -> Optional[StatsDict]:
    """A view of ``stats`` that prefixes the paths its writers record
    (shared stats plumbing for every model family); it carries
    ``stats``'s mesh group."""
    if stats is None:
        return None

    class _Prefixed(dict):
        group = getattr(stats, "group", None)

        def __setitem__(self, key, value):
            stats[(prefix,) + key] = value

    return _Prefixed()


def apply_conv_bn(x: torch.Tensor, p: ConvBN, *, stride: int = 1,
                  act: Optional[Callable] = B.relu, depthwise: bool = False,
                  padding: Optional[int] = None, output_padding: int = 0,
                  train: bool = False, stats: Optional[StatsDict] = None,
                  path: Tuple[str, ...] = (), space: Optional[S.Level] = None) -> torch.Tensor:
    """conv (+ bias) -> [BN] -> [act].  A transposed leaf (``p.transpose``)
    runs a transposed conv (``padding`` None means 0 there,
    ``output_padding`` as ``ConvTranspose2d``'s), grouped as its weight
    says: ``(Cin, Cout / groups, k, k)`` against the leaf's Cout (its
    BatchNorm's or bias's width), so a depthwise ``(C, 1, k, k)`` leaf
    runs C groups.  With ``train`` the BatchNorm normalises by the
    batch's moments (the global batch's when ``stats`` is a
    :class:`TrainStats` with a group) and its new running statistics go
    to ``stats[path + ('bn',)]``.  ``space``: ``x`` holds this rank's rows
    of that level of a height-sharded forward (inference only), and the
    conv is ``parallel.spatial.conv2d`` or ``conv_transpose2d``: its halo
    rows exchanged, the result this rank's rows of the output level."""
    if space is not None and train:
        raise ValueError("a height-sharded conv runs for inference only")
    if p.transpose:
        cout = (p.b if p.bn is None else p.bn.mean).shape[0]
        kw = dict(stride=stride, padding=padding or 0, output_padding=output_padding,
                  groups=cout // p.w.shape[1])
        if space is not None:
            y = S.conv_transpose2d(x, p.w, p.b, level=space, **kw)
        else:
            y = B.conv2d_transpose(x, p.w, bias=p.b, **kw)
    elif space is not None:
        y = S.conv2d(x, p.w, p.b, level=space, stride=stride, padding=padding,
                     groups=x.shape[1] if depthwise else 1)
    else:
        conv = B.depthwise_conv2d if depthwise else B.conv2d
        y = conv(x, p.w, stride=stride, padding=padding, bias=p.b)
    if p.bn is not None:
        if train:
            y, new_bn = B.batch_norm_train(y, p.bn, group=getattr(stats, "group", None))
            if stats is not None:
                stats[path + ("bn",)] = new_bn
        else:
            y = B.batch_norm(y, p.bn)
    return act(y) if act is not None else y


@torch.no_grad()
def merge_stats(params: nn.Module, stats: StatsDict) -> nn.Module:
    """Write the running statistics ``stats`` recorded into ``params``'s
    BatchNorm buffers, in place; returns ``params``.  Only ``mean`` and
    ``var`` are written: ``scale`` and ``bias`` stay as the optimiser left
    them."""
    for path, entry in stats.items():
        bn = params.get_submodule(".".join(path))
        for k, v in entry.items():
            getattr(bn, k).copy_(v)
    return params


def fold_params(p: ConvBN) -> ConvBN:
    """Fold ``bn`` into ``(w, b)``; an already-folded leaf passes through."""
    if p.bn is None:
        return p
    w, b = B.fold_bn(p.w, p.bn, transpose=p.transpose)
    return ConvBN(w, b=b, transpose=p.transpose)


@torch.no_grad()
def tree_fold(params: nn.Module) -> nn.Module:
    """A copy of ``params`` with every BatchNorm folded into its conv; the
    folded leaves are frozen, whatever the source's."""
    out = copy.deepcopy(params)
    unfolded = [(parent, name) for parent in out.modules()
                for name, child in parent.named_children()
                if isinstance(child, ConvBN) and child.bn is not None]
    for parent, name in unfolded:
        setattr(parent, name, fold_params(getattr(parent, name)))
    return out.requires_grad_(False)
