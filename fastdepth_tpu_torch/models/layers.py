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
from fastdepth_tpu_torch.ops.cuda import epilogue as E
from fastdepth_tpu_torch.ops.cuda import kernel
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
    or a conv with a bias and no BatchNorm, such as ResNet's ``conv2``);
    with ``plain``, neither (a conv with no bias, such as DPT's
    ``layer*_rn``).  ``w`` is OIHW, or with ``transpose`` a transposed
    conv's ``(Cin, Cout / groups, kh, kw)``: the leaf carries that so
    that folding scales the right axis (the JAX package's
    ``transpose_keys``)."""

    def __init__(self, w: torch.Tensor, *, b: Optional[torch.Tensor] = None,
                 bn: Optional[BatchNorm] = None, transpose: bool = False,
                 plain: bool = False):
        super().__init__()
        if plain and (b is not None or bn is not None):
            raise ValueError("a plain conv leaf holds neither b nor bn")
        if not plain and (b is None) == (bn is None):
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


def apply_linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """``x @ w + b`` over ``x``'s last axis, one GEMM with the bias."""
    y = torch.addmm(p.b, x.reshape(-1, x.shape[-1]), p.w)
    return y.view(*x.shape[:-1], y.shape[-1])


class LayerNorm(nn.Module):
    """LayerNorm's affine parameters over the last axis (``scale``,
    ``bias``, named like :class:`BatchNorm`'s); it has no running
    statistics, so nothing folds it."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = _frozen(torch.ones(c))
        self.bias = _frozen(torch.zeros(c))


def apply_layer_norm(x: torch.Tensor, p: LayerNorm, eps: float) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, p.scale.shape, p.scale, p.bias, eps)


class LayerScale(nn.Module):
    """A per-channel scale ``gamma`` on a residual branch (Touvron et al.,
    CaiT), applied as ``x + gamma * branch``."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = _frozen(torch.ones(c))


class Tokens(nn.Module):
    """A vision transformer's learned tokens: the class token ``cls``
    ``(1, 1, D)`` and the position embedding ``pos`` ``(1, 1 + patches,
    D)``."""

    def __init__(self, patches: int, dim: int):
        super().__init__()
        self.cls = _frozen(torch.zeros(1, 1, dim))
        self.pos = _frozen(torch.zeros(1, 1 + patches, dim))


def conv_leaf(w_shape: Sequence[int], *, folded: bool, transpose: bool = False,
              groups: int = 1, bias: bool = True) -> ConvBN:
    """A zero-filled leaf of the given weight shape, to be loaded from a
    state dict: OIHW, or with ``transpose`` ``(Cin, Cout / groups, kh,
    kw)``.  ``folded`` gives ``{'w','b'}`` (also the form of a conv with a
    bias and no BatchNorm), else ``{'w','bn'}``; ``bias=False`` gives
    ``{'w'}`` alone, a plain conv."""
    cout = w_shape[1] * groups if transpose else w_shape[0]
    w = torch.zeros(tuple(w_shape))
    if not bias:
        return ConvBN(w, transpose=transpose, plain=True)
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


# the activations K7 applies, by the callables the models pass as ``act``
_K7_ACTS = {None: E.NONE, B.relu: E.RELU, torch.relu: E.RELU, B.relu6: E.RELU6}
# the devices whose folded convs end in K7: on CUDA ATen adds a conv's
# bias as a pass of its own after cuDNN's conv; the CPU's conv adds it
# inside, so there K7 would only add passes
K7_DEVICES = ("cuda",)


def _k7_act(x: torch.Tensor, p: ConvBN, act: Optional[Callable], train: bool,
            space: Optional[S.Level], residual: Optional[torch.Tensor]) -> Optional[int]:
    """K7's code for ``act`` where the conv's epilogue goes through K7
    (``ops/cuda/epilogue.py``), else None: a folded leaf (``b``, no
    ``bn``), for inference (not ``train``, no operand requiring grad),
    not height-sharded, an activation K7 has, and f32 or bf16 operands of
    one dtype on a device of :data:`K7_DEVICES`."""
    code = _K7_ACTS.get(act, -1) if not train and space is None else -1
    b = p.b if code >= 0 and p.bn is None else None
    if b is None or x.dtype not in kernel.DTYPES or x.device.type not in K7_DEVICES:
        return None
    for t in (x, p.w, b, residual):
        if t is not None and (t.dtype != x.dtype or t.requires_grad):
            return None
    return code


def apply_conv_bn(x: torch.Tensor, p: ConvBN, *, stride: int = 1,
                  act: Optional[Callable] = B.relu, depthwise: bool = False,
                  padding: Optional[int] = None, output_padding: int = 0,
                  train: bool = False, stats: Optional[StatsDict] = None,
                  path: Tuple[str, ...] = (), space: Optional[S.Level] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv (+ bias) -> [BN] -> [+ residual] -> [act].  A transposed leaf
    (``p.transpose``) runs a transposed conv (``padding`` None means 0
    there, ``output_padding`` as ``ConvTranspose2d``'s), grouped as its
    weight says: ``(Cin, Cout / groups, k, k)`` against the leaf's Cout
    (its BatchNorm's or bias's width), so a depthwise ``(C, 1, k, k)``
    leaf runs C groups.  With ``train`` the BatchNorm normalises by the
    batch's moments (the global batch's when ``stats`` is a
    :class:`TrainStats` with a group) and its new running statistics go
    to ``stats[path + ('bn',)]``.  ``space``: ``x`` holds this rank's rows
    of that level of a height-sharded forward (inference only), and the
    conv is ``parallel.spatial.conv2d`` or ``conv_transpose2d``: its halo
    rows exchanged, the result this rank's rows of the output level.
    ``residual``: a tensor of the output's shape added before ``act``, as
    a residual block's sum.

    A folded conv for inference on the card (:func:`_k7_act`) runs
    without its bias, and K7 (``ops/cuda/epilogue.py``) adds the bias and
    the residual and applies ``act`` in one pass over its channels_last
    output, bit for bit the separate ops; every other conv takes the bias
    in the conv and the rest as separate ops."""
    if space is not None and train:
        raise ValueError("a height-sharded conv runs for inference only")
    k7 = _k7_act(x, p, act, train, space, residual)
    bias = None if k7 is not None else p.b
    if p.transpose:
        cout = (p.b if p.bn is None else p.bn.mean).shape[0]
        kw = dict(stride=stride, padding=padding or 0, output_padding=output_padding,
                  groups=cout // p.w.shape[1])
        if space is not None:
            y = S.conv_transpose2d(x, p.w, p.b, level=space, **kw)
        else:
            y = B.conv2d_transpose(x, p.w, bias=bias, **kw)
    elif space is not None:
        y = S.conv2d(x, p.w, p.b, level=space, stride=stride, padding=padding,
                     groups=x.shape[1] if depthwise else 1)
    else:
        conv = B.depthwise_conv2d if depthwise else B.conv2d
        y = conv(x, p.w, stride=stride, padding=padding, bias=bias)
    if k7 is not None:
        return E.launch(y, p.b, residual, k7)
    if p.bn is not None:
        if train:
            y, new_bn = B.batch_norm_train(y, p.bn, group=getattr(stats, "group", None))
            if stats is not None:
                stats[path + ("bn",)] = new_bn
        else:
            y = B.batch_norm(y, p.bn)
    if residual is not None:
        y = y + residual
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
