"""Work counts of MobileNet-NNConv5dw-skipadd (FastDepth): each conv's
multiply-adds at the configuration's shapes, the step's FLOPs, and the
bytes and FLOPs of each fused decoder level.  Every multiply-add here
has non-zero inputs, so the needed and the dense counts agree."""

from __future__ import annotations

from typing import List

from perfbench.work import common as W

SKIP_LEVELS = (2, 3, 4)


def convs(cfg: dict) -> List[dict]:
    """Every conv of one frame, in forward order."""
    enc, dec, k = cfg["encoder_channels"], cfg["decoder_channels"], cfg["decoder_kernel"]
    h, w = cfg["image_size"]
    out = [W.conv("encoder.conv0", 3, enc[0], 3, h, w, stride=2)]
    h, w = out[-1]["hout"], out[-1]["wout"]
    for i, s in enumerate(cfg["encoder_strides"], start=1):
        out.append(W.conv(f"encoder.conv{i}.dw", enc[i - 1], enc[i - 1], 3, h, w, stride=s,
                          groups=enc[i - 1]))
        h, w = out[-1]["hout"], out[-1]["wout"]
        out.append(W.conv(f"encoder.conv{i}.pw", enc[i - 1], enc[i], 1, h, w))
    cin = enc[-1]
    for i, cout in enumerate(dec, start=1):
        out.append(W.conv(f"decoder.decode_conv{i}.dw", cin, cin, k, h, w, groups=cin))
        out.append(W.conv(f"decoder.decode_conv{i}.pw", cin, cout, 1, h, w))
        h, w, cin = 2 * h, 2 * w, cout
    out.append(W.conv("decoder.decode_conv6.pw", cin, 1, 1, h, w))
    return out


def step_flops(cfg: dict) -> float:
    """FLOPs one frame needs: 2 x the multiply-adds of every conv."""
    return 2.0 * sum(c["needed_macs"] for c in convs(cfg))


def decoder_levels(cfg: dict, n: int, elem_bytes: int) -> List[tuple]:
    """(bytes, FLOPs) of each of the five fused decoder levels of a batch
    of ``n`` frames (:func:`perfbench.work.common.stage_work`)."""
    enc, dec = cfg["encoder_channels"], cfg["decoder_channels"]
    h = w = None
    for c in convs(cfg):
        if c["name"] == "decoder.decode_conv1.dw":
            h, w = c["h"], c["w"]
    cin, out = enc[-1], []
    for i, cout in enumerate(dec, start=1):
        out.append(W.stage_work(n, h, w, cin, cout, i in SKIP_LEVELS, elem_bytes))
        h, w, cin = 2 * h, 2 * w, cout
    return out
