"""Work counts of ResNet-50 + UpProj: each conv's multiply-adds at the
configuration's shapes, and the step's FLOPs.

The up-projections' 5 x 5 convs run over zero-inserted maps: of the
multiply-adds a dense count gives them, only those whose input is one
of the unpooled values are needed (Laina et al.'s fast up-projection
computes the same function from those alone).  ``needed_macs`` counts
those; ``macs`` the dense count, as ``torch.utils.flop_counter`` does."""

from __future__ import annotations

from typing import List

from perfbench.work import common as W


def _taps_on_even(size: int, k: int = 5) -> int:
    """Over the outputs of one axis of a 'same' k-tap conv on a map of
    ``size``, the taps that land on an even (unpooled) input."""
    r = (k - 1) // 2
    return sum(1 for y in range(size) for d in range(-r, r + 1)
               if 0 <= y + d < size and (y + d) % 2 == 0)


def convs(cfg: dict) -> List[dict]:
    """Every conv of one frame, in forward order."""
    h, w = cfg["image_size"]
    e = cfg["expansion"]
    out = [W.conv("encoder.conv1", 3, cfg["stem_channels"], 7, h, w, stride=2, padding=3)]
    h, w = (W.out_size(s, 3, 2, 1) for s in (out[-1]["hout"], out[-1]["wout"]))  # max pool
    cin = cfg["stem_channels"]
    for s, (width, n) in enumerate(zip(cfg["stage_widths"], cfg["layers"]), start=1):
        for b in range(n):
            stride = 2 if (b == 0 and s > 1) else 1
            key = f"encoder.layer{s}.block{b}"
            out.append(W.conv(f"{key}.conv1", cin, width, 1, h, w))
            out.append(W.conv(f"{key}.conv2", width, width, 3, h, w, stride=stride))
            ho, wo = out[-1]["hout"], out[-1]["wout"]
            out.append(W.conv(f"{key}.conv3", width, width * e, 1, ho, wo))
            if stride != 1 or cin != width * e:
                out.append(W.conv(f"{key}.downsample", cin, width * e, 1, h, w, stride=stride))
            h, w, cin = ho, wo, width * e
    out.append(W.conv("conv2", cin, cfg["decoder_in"], 1, h, w))
    cin = cfg["decoder_in"]
    for i, cout in enumerate(cfg["decoder_channels"], start=1):
        h, w = 2 * h, 2 * w
        key = f"decoder.stage{i}"
        for name, ci, k in (("branch1_conv1", cin, 5), ("branch1_conv2", cout, 3),
                            ("branch2_conv", cin, 5)):
            c = W.conv(f"{key}.{name}", ci, cout, k, h, w)
            if k == 5:  # over the zero-inserted map
                c["needed_macs"] = ci * cout * _taps_on_even(h) * _taps_on_even(w)
            out.append(c)
        cin = cout
    out.append(W.conv("decoder.final.pw", cin, 1, 1, h, w))
    return out


def step_flops(cfg: dict) -> float:
    """FLOPs one frame needs: 2 x the multiply-adds with non-zero inputs."""
    return 2.0 * sum(c["needed_macs"] for c in convs(cfg))


def dense_flops(cfg: dict) -> float:
    """FLOPs of the plain forward, the zero inputs' multiply-adds too."""
    return 2.0 * sum(c["macs"] for c in convs(cfg))
