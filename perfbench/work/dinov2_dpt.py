"""Work counts of Depth Anything V2 (DINOv2 ViT + DPT head): every dense
product of one frame as a row of ``perfbench/work/common.conv``'s
format, and the step's FLOPs.

The encoder's rows (``encoder.*``): the patch conv; each block's four
linears, written as 1 x 1 convs over the N tokens (``h = N``, ``w =
1``); and its two attention products, q k^T and the scores times v,
each N x N x dim multiply-adds (a 1 x 1 conv from ``dim`` to N channels
over the N tokens).  The head's rows have no ``encoder.`` prefix.
LayerNorm, softmax, GELU, the resizes and the adds are not counted, as
``torch.utils.flop_counter`` counts none of them."""

from __future__ import annotations

from typing import List

from perfbench.work import common as W


def tokens(cfg: dict) -> int:
    """N: the patches and the class token."""
    h, w = (s // cfg["patch_size"] for s in cfg["image_size"])
    return 1 + h * w


def _tconv(name: str, c: int, k: int, h: int, w: int) -> dict:
    """A transposed conv with stride = kernel = ``k``: each output takes
    one tap of each input channel."""
    row = W.conv(name, c, c, 1, h * k, w * k)
    return dict(row, k=k, h=h, w=w)


def convs(cfg: dict) -> List[dict]:
    """Every dense product of one frame, in forward order."""
    d, m, f, p = cfg["embed_dim"], cfg["mlp_dim"], cfg["features"], cfg["patch_size"]
    n = tokens(cfg)
    out = [W.conv("encoder.patch_embed", 3, d, p, *cfg["image_size"], stride=p, padding=0)]
    gh, gw = out[0]["hout"], out[0]["wout"]
    for i in range(cfg["depth"]):
        key = f"encoder.block{i}"
        out += [W.conv(f"{key}.qkv", d, 3 * d, 1, n, 1),
                W.conv(f"{key}.attn_qk", d, n, 1, n, 1),
                W.conv(f"{key}.attn_pv", d, n, 1, n, 1),
                W.conv(f"{key}.proj", d, d, 1, n, 1),
                W.conv(f"{key}.fc1", d, m, 1, n, 1),
                W.conv(f"{key}.fc2", m, d, 1, n, 1)]
    oc = cfg["decoder_channels"]
    sizes = []
    for i, c in enumerate(oc, start=1):
        out.append(W.conv(f"decoder.project{i}", d, c, 1, gh, gw))
        if i == 1:
            out.append(_tconv("decoder.resize1", c, 4, gh, gw))
        elif i == 2:
            out.append(_tconv("decoder.resize2", c, 2, gh, gw))
        elif i == 4:
            out.append(W.conv("decoder.resize4", c, c, 3, gh, gw, stride=2))
        sizes.append((out[-1]["hout"], out[-1]["wout"]))
        out.append(W.conv(f"decoder.layer{i}_rn", c, f, 3, *sizes[-1]))
    for j in (4, 3, 2, 1):
        h, w = sizes[j - 1]
        units = ("rcu1", "rcu2") if j < 4 else ("rcu2",)
        out += [W.conv(f"decoder.refine{j}.{u}.{c}", f, f, 3, h, w)
                for u in units for c in ("conv1", "conv2")]
        h, w = sizes[j - 2] if j > 1 else (2 * h, 2 * w)
        out.append(W.conv(f"decoder.refine{j}.out", f, f, 1, h, w))
    out.append(W.conv("decoder.out_conv1", f, f // 2, 3, h, w))
    h, w = cfg["image_size"]
    out.append(W.conv("decoder.out_conv2", f // 2, cfg["head_hidden"], 3, h, w))
    out.append(W.conv("decoder.out_conv3", cfg["head_hidden"], 1, 1, h, w))
    return out


def step_flops(cfg: dict) -> float:
    """FLOPs of one frame: 2 x every product's multiply-adds."""
    return 2.0 * sum(c["needed_macs"] for c in convs(cfg))


def attention_flops(cfg: dict) -> float:
    """FLOPs of one frame's attention products: 4 N^2 dim a block."""
    return 4.0 * tokens(cfg) ** 2 * cfg["embed_dim"] * cfg["depth"]
