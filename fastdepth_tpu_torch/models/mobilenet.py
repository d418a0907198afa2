"""MobileNetV1 encoder, channel-list parameterized — counterpart of
``fastdepth_tpu/models/mobilenet.py`` (reference imagenet/mobilenet.py:
stem conv_bn(3, c0, s2), then 13 depthwise-separable blocks with ReLU6).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from fastdepth_tpu_torch.config import MOBILENET_STRIDES, MOBILENET_V1_CHANNELS
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import blocks as B


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
                  stats: Optional[L.StatsDict] = None
                  ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Run the encoder on channels_last NCHW; returns (features,
    {block_index: tap_activation}) (reference models.py:710-719 taps
    i == 1, 3, 5).  ``train``/``stats``: see ``layers.apply_conv_bn``; the
    paths are ``('conv0', 'bn')`` and ``('convK', 'dw'|'pw', 'bn')``."""
    act = B.relu6 if relu6 else B.relu
    tapped: Dict[int, torch.Tensor] = {}
    x = L.apply_conv_bn(x, params["conv0"], stride=2, act=act, train=train, stats=stats,
                        path=("conv0",))
    if 0 in taps:
        tapped[0] = x
    for i in range(1, 14):
        p = params[f"conv{i}"]
        x = L.apply_conv_bn(x, p["dw"], stride=MOBILENET_STRIDES[i - 1], act=act,
                            depthwise=True, train=train, stats=stats, path=(f"conv{i}", "dw"))
        x = L.apply_conv_bn(x, p["pw"], act=act, train=train, stats=stats,
                            path=(f"conv{i}", "pw"))
        if i in taps:
            tapped[i] = x
    return x, tapped
