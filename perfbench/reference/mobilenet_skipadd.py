"""Plain reference of FastDepth's MobileNet-NNConv5dw-skipadd (Wofk et
al., ICRA 2019; the released ``MobileNetSkipAdd``), in f32 PyTorch.

Encoder: a 3 x 3 stride-2 stem and 13 depthwise-separable blocks
(3 x 3 depthwise, 1 x 1 pointwise), each conv followed by BatchNorm and
ReLU6.  Decoder: five levels of 5 x 5 depthwise + 1 x 1 pointwise, each
with BatchNorm and ReLU, then a nearest x2 upsample; after levels 2, 3
and 4 the outputs of encoder blocks 5, 3 and 1 are added.  A 1 x 1 conv
with BatchNorm and ReLU gives the depth.  Widths come from the
configuration file (the pruned model's are NetAdapt's per-layer
channels).  Parameters are named as the project's checkpoints name them
(``encoder.conv3.dw.w``, ``decoder.decode_conv2.pw.bn.scale``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import common as C

SKIP_AFTER = {2: 5, 3: 3, 4: 1}  # decoder level -> encoder block added after it


def schema(cfg: dict) -> List[tuple]:
    """The parameter tree's rows ``(name, shape, law, a, b)``."""
    enc, dec, k = cfg["encoder_channels"], cfg["decoder_channels"], cfg["decoder_kernel"]
    rows = C.conv_bn_leaf("encoder.conv0", (enc[0], 3, 3, 3))
    for i in range(1, 14):
        rows += C.conv_bn_leaf(f"encoder.conv{i}.dw", (enc[i - 1], 1, 3, 3))
        rows += C.conv_bn_leaf(f"encoder.conv{i}.pw", (enc[i], enc[i - 1], 1, 1))
    cin = enc[-1]
    for i, cout in enumerate(dec, start=1):
        rows += C.conv_bn_leaf(f"decoder.decode_conv{i}.dw", (cin, 1, k, k))
        rows += C.conv_bn_leaf(f"decoder.decode_conv{i}.pw", (cout, cin, 1, 1))
        cin = cout
    rows += C.conv_bn_leaf("decoder.decode_conv6.pw", (1, cin, 1, 1), head=True)
    return rows


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            conv: C.Conv = C.conv2d) -> torch.Tensor:
    """NHWC frames (uint8 or f32) -> NHWC (N, H, W, 1) f32 depth."""

    def cbr(y, key, stride=1, depthwise=False, act=torch.relu):
        w, b = C.fold(sd, key)
        y = conv(y, w, b, stride=stride, padding=(w.shape[-1] - 1) // 2,
                 groups=y.shape[1] if depthwise else 1)
        return act(y)

    relu6 = lambda t: t.clamp(0, 6)  # noqa: E731
    y = cbr(C.to_input(x), "encoder.conv0", stride=2, act=relu6)
    taps = {}
    for i, stride in enumerate(cfg["encoder_strides"], start=1):
        y = cbr(y, f"encoder.conv{i}.dw", stride=stride, depthwise=True, act=relu6)
        y = cbr(y, f"encoder.conv{i}.pw", act=relu6)
        taps[i] = y
    for i in range(1, 6):
        y = cbr(y, f"decoder.decode_conv{i}.dw", depthwise=True)
        y = C.upsample_nearest2x(cbr(y, f"decoder.decode_conv{i}.pw"))
        if i in SKIP_AFTER:
            y = y + taps[SKIP_AFTER[i]]
    return cbr(y, "decoder.decode_conv6.pw").permute(0, 2, 3, 1)
