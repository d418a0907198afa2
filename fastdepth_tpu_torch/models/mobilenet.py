"""MobileNetV1 encoder, channel-list parameterized, and its ImageNet
classifier head — counterpart of ``fastdepth_tpu/models/mobilenet.py``
(reference imagenet/mobilenet.py: stem conv_bn(3, c0, s2), then 13
depthwise-separable blocks with ReLU6; AvgPool2d(7) + Linear(1024,
1000)).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from fastdepth_tpu_torch.config import MOBILENET_STRIDES, MOBILENET_V1_CHANNELS
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.ops import init as I
from fastdepth_tpu_torch.parallel import spatial as S


def make_encoder(channels: Sequence[int] = MOBILENET_V1_CHANNELS,
                 in_channels: int = 3, *, folded: bool = False) -> nn.ModuleDict:
    """The encoder's parameter tree (stem + 13 blocks), zero-filled, shaped
    like the npz tree's ``encoder`` subtree."""
    tree = nn.ModuleDict({
        "conv0": L.conv_leaf((channels[0], in_channels, 3, 3), folded=folded)})
    cin = channels[0]
    for i in range(1, 14):
        cout = channels[i]
        tree[f"conv{i}"] = nn.ModuleDict({
            "dw": L.conv_leaf((cin, 1, 3, 3), folded=folded),
            "pw": L.conv_leaf((cout, cin, 1, 1), folded=folded),
        })
        cin = cout
    return tree


def apply_encoder(params: nn.ModuleDict, x: torch.Tensor, *, relu6: bool = True,
                  taps: Tuple[int, ...] = (), train: bool = False,
                  stats: Optional[L.StatsDict] = None, space: Optional[S.Level] = None
                  ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Run the encoder on channels_last NCHW; returns (features,
    {block_index: tap_activation}) (reference models.py:710-719 taps
    i == 1, 3, 5).  ``train``/``stats``: see ``layers.apply_conv_bn``; the
    paths are ``('conv0', 'bn')`` and ``('convK', 'dw'|'pw', 'bn')``.
    ``space``: the level of ``x`` in a height-sharded forward; every
    activation, the taps too, is then this rank's rows of its level
    (``parallel/spatial.py``).  The pass is one ``engine/profiler.ENCODER``
    span."""
    act = B.relu6 if relu6 else B.relu
    tapped: Dict[int, torch.Tensor] = {}
    with P.annotate(P.ENCODER):
        x = L.apply_conv_bn(x, params["conv0"], stride=2, act=act, train=train, stats=stats,
                            path=("conv0",), space=space)
        space = space and space.down()
        if 0 in taps:
            tapped[0] = x
        for i in range(1, 14):
            p = params[f"conv{i}"]
            stride = MOBILENET_STRIDES[i - 1]
            x = L.apply_conv_bn(x, p["dw"], stride=stride, act=act, depthwise=True,
                                train=train, stats=stats, path=(f"conv{i}", "dw"), space=space)
            space = space and space.down(stride=stride)
            x = L.apply_conv_bn(x, p["pw"], act=act, train=train, stats=stats,
                                path=(f"conv{i}", "pw"), space=space)
            if i in taps:
                tapped[i] = x
    return x, tapped


def output_level(level: Optional[S.Level]) -> Optional[S.Level]:
    """The encoder's output level of a height-sharded forward whose input
    has ``level`` (None stays None): the stem's and the blocks' strides."""
    if level is not None:
        for stride in (2, *MOBILENET_STRIDES):
            level = level.down(stride=stride)
    return level


def make_classifier(features: int = 1024, classes: int = 1000) -> nn.ModuleDict:
    """The ImageNet head's tree ``{'fc': {'w': (features, classes), 'b':
    (classes,)}}``, zero-filled."""
    return nn.ModuleDict({"fc": L.Linear(features, classes)})


def init_classifier(generator: torch.Generator, features: int = 1024,
                    classes: int = 1000) -> nn.ModuleDict:
    """The head at torch Linear's default init, U(+-1/sqrt(features)) for
    ``w`` and ``b`` (``ops/init.uniform_linear``), drawn from
    ``generator``."""
    head = make_classifier(features, classes)
    head["fc"].w.data, head["fc"].b.data = I.uniform_linear(features, classes, generator)
    return head


def apply_classifier(params: nn.ModuleDict, feats: torch.Tensor) -> torch.Tensor:
    """Encoder features (channels_last NCHW) -> ``(N, classes)`` logits:
    a global average pool (7x7 at 224^2) and ``x @ w + b``."""
    x = B.avg_pool(feats, feats.shape[-1]).reshape(feats.shape[0], -1)
    return x @ params["fc"].w + params["fc"].b


def classifier_topk(logits: torch.Tensor, labels: torch.Tensor,
                    ks: Tuple[int, ...] = (1, 5)) -> Dict[int, torch.Tensor]:
    """Top-k accuracies (fractions in [0, 1]) of an ``(N, classes)``
    logits batch, the torch ImageNet harness's ``accuracy(output, target,
    topk=(1, 5))`` under which the reference reports ``best_prec1``
    (imagenet/mobilenet.py:65-76).  Ties go to the lower class index, as
    JAX's ``lax.top_k`` gives them: a stable descending sort (``torch.topk``
    promises no order among ties).  Each accuracy is a device scalar."""
    idx = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :max(ks)]
    hits = idx == labels[:, None]
    return {k: hits[:, :k].any(dim=1).float().mean() for k in ks}
