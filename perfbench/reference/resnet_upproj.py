"""Plain reference of ResNet-50 + UpProj (Laina et al., "Deeper Depth
Prediction with Fully Convolutional Residual Networks", 3DV 2016,
arXiv:1606.00373), in f32 PyTorch.

Encoder: torchvision's ResNet-50 (a 7 x 7 stride-2 stem with BatchNorm
and ReLU, a 3 x 3 stride-2 max pool, then bottleneck blocks of 1 x 1,
3 x 3 (the stride) and 1 x 1 convs, each with BatchNorm, a 1 x 1
projection with BatchNorm on the first block of a layer); then a 1 x 1
conv with a bias to 1024 channels.  Decoder: five up-projections, each
a zero-inserting 2 x unpool ``u``, then
relu(bn(conv3x3(relu(bn(conv5x5(u))))) + bn(conv5x5'(u))); a 1 x 1 conv
with BatchNorm and ReLU gives the depth.  The 5 x 5
convs run over the zero-inserted maps, as the paper's plain
up-projection does; its fast up-projection computes the same function
from the non-zero inputs alone (``perfbench/work/resnet_upproj.py``
counts both).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def _blocks(cfg: dict):
    """(layer, block, cin, width, stride) of every bottleneck block."""
    cin = cfg["stem_channels"]
    for s, (width, n) in enumerate(zip(cfg["stage_widths"], cfg["layers"]), start=1):
        for b in range(n):
            yield s, b, cin, width, 2 if (b == 0 and s > 1) else 1
            cin = width * cfg["expansion"]


def schema(cfg: dict) -> List[tuple]:
    """The parameter tree's rows ``(name, shape, law, a, b)``.  The last
    BatchNorm of each residual branch is drawn damped, so that sixteen
    residual sums keep the activations' scale."""
    e = cfg["expansion"]
    rows = C.conv_bn_leaf("encoder.conv1", (cfg["stem_channels"], 3, 7, 7))
    for s, b, cin, width, stride in _blocks(cfg):
        key = f"encoder.layer{s}.block{b}"
        rows += C.conv_bn_leaf(f"{key}.conv1", (width, cin, 1, 1))
        rows += C.conv_bn_leaf(f"{key}.conv2", (width, width, 3, 3))
        rows += C.conv_bn_leaf(f"{key}.conv3", (width * e, width, 1, 1), damped=True)
        if stride != 1 or cin != width * e:
            rows += C.conv_bn_leaf(f"{key}.downsample", (width * e, cin, 1, 1))
    feats, mid = cfg["stage_widths"][-1] * e, cfg["decoder_in"]
    rows += [("conv2.w", (mid, feats, 1, 1), "normal", 0.0, (2.0 / feats) ** 0.5),
             ("conv2.b", (mid,), "uniform", -0.1, 0.1)]
    cin = mid
    for i, cout in enumerate(cfg["decoder_channels"], start=1):
        key = f"decoder.stage{i}"
        # a 5 x 5 window over a zero-inserted map holds a quarter of its
        # taps' inputs, on average
        rows += C.conv_bn_leaf(f"{key}.branch1_conv1", (cout, cin, 5, 5), fan_in=cin * 25 / 4)
        rows += C.conv_bn_leaf(f"{key}.branch1_conv2", (cout, cout, 3, 3))
        rows += C.conv_bn_leaf(f"{key}.branch2_conv", (cout, cin, 5, 5), fan_in=cin * 25 / 4)
        cin = cout
    rows += C.conv_bn_leaf("decoder.final.pw", (1, cin, 1, 1), head=True)
    return rows


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            conv: C.Conv = C.conv2d) -> torch.Tensor:
    """NHWC frames (uint8 or f32) -> NHWC (N, H, W, 1) f32 depth."""

    def cb(y, key, stride=1, padding=None, act=None):
        w, b = C.fold(sd, key)
        k = w.shape[-1]
        y = conv(y, w, b, stride=stride, padding=(k - 1) // 2 if padding is None else padding)
        return act(y) if act is not None else y

    y = cb(C.to_input(x), "encoder.conv1", stride=2, padding=3, act=torch.relu)
    y = F.max_pool2d(y, 3, 2, 1)
    for s, b, cin, width, stride in _blocks(cfg):
        key = f"encoder.layer{s}.block{b}"
        r = cb(y, f"{key}.conv1", act=torch.relu)
        r = cb(r, f"{key}.conv2", stride=stride, act=torch.relu)
        r = cb(r, f"{key}.conv3")
        idn = cb(y, f"{key}.downsample", stride=stride) if f"{key}.downsample.w" in sd else y
        y = torch.relu(r + idn)
    y = cb(y, "conv2")
    for i in range(1, len(cfg["decoder_channels"]) + 1):
        key = f"decoder.stage{i}"
        u = C.unpool_zero(y)
        b1 = cb(cb(u, f"{key}.branch1_conv1", act=torch.relu), f"{key}.branch1_conv2")
        y = torch.relu(b1 + cb(u, f"{key}.branch2_conv"))
    return cb(y, "decoder.final.pw", act=torch.relu).permute(0, 2, 3, 1)
