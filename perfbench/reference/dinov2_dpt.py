"""Plain reference of Depth Anything V2, metric (Yang et al., NeurIPS
2024, arXiv:2406.09414; github.com/DepthAnything/Depth-Anything-V2,
``metric_depth/``): a DINOv2 ViT encoder (Oquab et al., arXiv:2304.07193)
and a DPT head (Ranftl et al., arXiv:2103.13413), in f32 PyTorch.

Encoder: the frame in [0, 1], minus ImageNet's mean, over its std; a
14 x 14 stride-14 conv with a bias; the class token prepended and the
position embedding added; ``depth`` blocks of

    x = x + gamma1 * (attn(LN1(x)) @ Wproj + bproj)
    x = x + gamma2 * (GELU(LN2(x) @ Wfc1 + bfc1) @ Wfc2 + bfc2)

where attn splits ``LN1(x) @ Wqkv + bqkv`` into q, k, v of ``num_heads``
heads and takes softmax(q k^T / sqrt(head dim)) v, LayerNorm eps
``ln_eps``, GELU the exact (erf) form.  The outputs of the ``taps``
blocks (0-based) go through the final LayerNorm, lose the class token
and become ``(B, D, H / 14, W / 14)`` maps.

DPT head (``DPTHead``, ``use_bn=False``, ``use_clstoken=False``): tap i
through a 1 x 1 conv to ``decoder_channels[i]``, then a 4 x 4 stride-4
transposed conv, a 2 x 2 stride-2 transposed conv, nothing, a 3 x 3
stride-2 conv (padding 1); then a 3 x 3 conv without bias to
``features``.  RCU(x) = x + conv3(relu(conv3(relu(x)))); the fusion
block takes y = a (+ RCU1(b)), RCU2(y), a bilinear resize with
``align_corners=True`` to the next level's size (x2 at the last), and a
1 x 1 conv.  Last: a 3 x 3 conv to ``features / 2``, a bilinear resize
to the frame (``align_corners=True``), a 3 x 3 conv to 32, ReLU, a
1 x 1 conv to 1, sigmoid, times ``max_depth``.

The keys, against the released checkpoint's: ``encoder.*`` is
``pretrained.*`` (``tokens.cls`` / ``tokens.pos`` the ``cls_token`` /
``pos_embed``; ``block{i}.qkv`` / ``proj`` ``blocks.{i}.attn.*``;
``fc1`` / ``fc2`` ``blocks.{i}.mlp.*``; ``norm*.scale`` / ``.bias`` the
LayerNorms' weight / bias; ``ls*.gamma``), every linear's ``w`` the
transpose of its ``weight``; ``decoder.project{i}`` / ``resize{1,2,4}``
are ``depth_head.projects[i - 1]`` / ``resize_layers[i - 1]``;
``layer{i}_rn`` / ``refine{j}`` are ``depth_head.scratch.layer{i}_rn`` /
``refinenet{j}`` (``rcu1`` / ``rcu2`` / ``out`` its ``resConfUnit1`` /
``resConfUnit2`` / ``out_conv``); ``out_conv1`` is ``output_conv1``,
``out_conv2`` / ``out_conv3`` are ``output_conv2[0]`` / ``[2]``.

Departures from the released model, none of which changes what a frame
gives: DINOv2's ``mask_token`` (used only in training) and
``refinenet4``'s ``resConfUnit1`` (never called: level 4 has nothing to
fuse) are left out; the position embedding is sized for the frame
(at 518 x 518 the published one, so it needs no interpolation).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def _grid(cfg: dict):
    return [s // cfg["patch_size"] for s in cfg["image_size"]]


def _linear(key: str, cin: int, cout: int) -> List[tuple]:
    """A linear's rows: LeCun-normal ``w`` (cin, cout), so a layer keeps
    its input's scale, and a small bias."""
    return [(f"{key}.w", (cin, cout), "normal", 0.0, cin ** -0.5),
            (f"{key}.b", (cout,), "uniform", -0.1, 0.1)]


def _norm(key: str, c: int) -> List[tuple]:
    """A LayerNorm's rows: scales around 1, biases around 0."""
    return [(f"{key}.scale", (c,), "uniform", 0.5, 1.5),
            (f"{key}.bias", (c,), "uniform", -0.2, 0.2)]


def _conv(key: str, cout: int, cin: int, k: int, bias: bool = True,
          transpose: bool = False) -> List[tuple]:
    """A conv's rows: normal ``w`` with std sqrt(1 / fan_in), so a conv
    keeps its input's scale, and a small bias.  A transposed conv with
    its stride equal to its kernel gives each output one tap per input
    channel: fan_in = cin."""
    shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
    fan_in = cin if transpose else cin * k * k
    rows = [(f"{key}.w", shape, "normal", 0.0, fan_in ** -0.5)]
    return rows + ([(f"{key}.b", (cout,), "uniform", -0.1, 0.1)] if bias else [])


def schema(cfg: dict) -> List[tuple]:
    """The parameter tree's rows ``(name, shape, law, a, b)``, drawn so
    that every part of the forward moves the depth: LayerScale gammas at
    trained-like sizes (U(0.1, 1.0), neither an init's 1e-5 nor 1), a
    class token and a position embedding of the patch tokens' scale, and
    a last 1 x 1 conv with non-negative weights over its non-negative
    (ReLU) inputs and a bias in [-3, -2.5], so that every pixel's logit
    is at least -3 (depth at least 20 sigmoid(-3) = 0.95 m) and most lie
    well under the sigmoid's top."""
    d, m, f = cfg["embed_dim"], cfg["mlp_dim"], cfg["features"]
    h, w = _grid(cfg)
    p = cfg["patch_size"]
    rows = _conv("encoder.patch_embed", d, 3, p)
    rows += [("encoder.tokens.cls", (1, 1, d), "normal", 0.0, 1.0),
             ("encoder.tokens.pos", (1, 1 + h * w, d), "normal", 0.0, 0.5)]
    for i in range(cfg["depth"]):
        key = f"encoder.block{i}"
        rows += _norm(f"{key}.norm1", d) + _linear(f"{key}.qkv", d, 3 * d)
        rows += _linear(f"{key}.proj", d, d)
        rows += [(f"{key}.ls1.gamma", (d,), "uniform", 0.1, 1.0)]
        rows += _norm(f"{key}.norm2", d) + _linear(f"{key}.fc1", d, m)
        rows += _linear(f"{key}.fc2", m, d)
        rows += [(f"{key}.ls2.gamma", (d,), "uniform", 0.1, 1.0)]
    rows += _norm("encoder.norm", d)
    oc = cfg["decoder_channels"]
    for i, c in enumerate(oc, start=1):
        rows += _conv(f"decoder.project{i}", c, d, 1)
    rows += _conv("decoder.resize1", oc[0], oc[0], 4, transpose=True)
    rows += _conv("decoder.resize2", oc[1], oc[1], 2, transpose=True)
    rows += _conv("decoder.resize4", oc[3], oc[3], 3)
    for i, c in enumerate(oc, start=1):
        rows += _conv(f"decoder.layer{i}_rn", f, c, 3, bias=False)
    for j in range(1, 5):
        units = ("rcu1", "rcu2") if j < 4 else ("rcu2",)
        for u in units:
            rows += _conv(f"decoder.refine{j}.{u}.conv1", f, f, 3)
            rows += _conv(f"decoder.refine{j}.{u}.conv2", f, f, 3)
        rows += _conv(f"decoder.refine{j}.out", f, f, 1)
    hid = cfg["head_hidden"]
    rows += _conv("decoder.out_conv1", f // 2, f, 3)
    rows += _conv("decoder.out_conv2", hid, f // 2, 3)
    rows += [("decoder.out_conv3.w", (1, hid, 1, 1), "abs_normal", 0.0, 0.1),
             ("decoder.out_conv3.b", (1,), "uniform", -3.0, -2.5)]
    return rows


def _rounding(conv: C.Conv) -> Callable[[torch.Tensor], torch.Tensor]:
    """How the precision whose convolution is ``conv`` rounds a GEMM's
    operands: not at all (f32, and TF32 through the backend switches),
    to bfloat16 (computed in bfloat16), or to float8 e4m3 (accumulated
    in f32)."""
    if conv is C.conv2d_bf16:
        return torch.Tensor.bfloat16
    if conv is C.conv2d_fp8:
        return C.fp8
    return lambda t: t


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            conv: C.Conv = C.conv2d) -> torch.Tensor:
    """NHWC frames (uint8 or f32) -> NHWC (N, H, W, 1) f32 depth in
    metres.  ``conv`` is the precision's convolution; the linears, the
    attention products and the transposed convs round their operands as
    it does (:func:`_rounding`)."""
    rnd = _rounding(conv)
    eps, heads, d = cfg["ln_eps"], cfg["num_heads"], cfg["embed_dim"]

    def mm(a, b):
        return (rnd(a) @ rnd(b)).float()

    def linear(t, key):
        return mm(t, sd[f"{key}.w"]) + sd[f"{key}.b"]

    def ln(t, key):
        return F.layer_norm(t, (d,), sd[f"{key}.scale"], sd[f"{key}.bias"], eps)

    def cv(y, key, stride=1, act=None):
        w = sd[f"{key}.w"]
        y = conv(y, w, sd.get(f"{key}.b"), stride=stride, padding=(w.shape[-1] - 1) // 2)
        return act(y) if act is not None else y

    def cv_t(y, key, stride):
        y = F.conv_transpose2d(rnd(y), rnd(sd[f"{key}.w"]), stride=stride).float()
        return y + sd[f"{key}.b"].view(1, -1, 1, 1)

    def resize(y, size):
        return F.interpolate(y, size=tuple(size), mode="bilinear", align_corners=True)

    mean, std = (torch.tensor(cfg[k], device=x.device).view(1, 3, 1, 1) for k in ("mean", "std"))
    y = (C.to_input(x) - mean) / std
    y = conv(y, sd["encoder.patch_embed.w"], sd["encoder.patch_embed.b"],
             stride=cfg["patch_size"], padding=0)
    b, _, h, w = y.shape
    t = torch.cat([sd["encoder.tokens.cls"].expand(b, 1, d), y.flatten(2).transpose(1, 2)], 1)
    t = t + sd["encoder.tokens.pos"]
    n = t.shape[1]
    taps = []
    for i in range(cfg["depth"]):
        key = f"encoder.block{i}"
        q, k, v = linear(ln(t, f"{key}.norm1"), f"{key}.qkv").view(
            b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        scores = mm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
        a = mm(scores.softmax(dim=-1), v).transpose(1, 2).reshape(b, n, d)
        t = t + sd[f"{key}.ls1.gamma"] * linear(a, f"{key}.proj")
        hid = F.gelu(linear(ln(t, f"{key}.norm2"), f"{key}.fc1"))
        t = t + sd[f"{key}.ls2.gamma"] * linear(hid, f"{key}.fc2")
        if i in cfg["taps"]:
            taps.append(ln(t, "encoder.norm")[:, 1:].transpose(1, 2).reshape(b, d, h, w))

    levels = []
    for i, tap in enumerate(taps, start=1):
        y = cv(tap, f"decoder.project{i}")
        if i == 1:
            y = cv_t(y, "decoder.resize1", 4)
        elif i == 2:
            y = cv_t(y, "decoder.resize2", 2)
        elif i == 4:
            y = cv(y, "decoder.resize4", stride=2)
        levels.append(cv(y, f"decoder.layer{i}_rn"))

    def rcu(y, key):
        return y + cv(cv(torch.relu(y), f"{key}.conv1", act=torch.relu), f"{key}.conv2")

    def fuse(j, a, skip, size):
        key = f"decoder.refine{j}"
        y = a if skip is None else a + rcu(skip, f"{key}.rcu1")
        y = rcu(y, f"{key}.rcu2")
        return cv(resize(y, size if size is not None else [2 * s for s in y.shape[2:]]),
                  f"{key}.out")

    l1, l2, l3, l4 = levels
    path = fuse(4, l4, None, l3.shape[2:])
    path = fuse(3, path, l3, l2.shape[2:])
    path = fuse(2, path, l2, l1.shape[2:])
    path = fuse(1, path, l1, None)
    y = resize(cv(path, "decoder.out_conv1"), cfg["image_size"])
    y = cv(cv(y, "decoder.out_conv2", act=torch.relu), "decoder.out_conv3")
    return (torch.sigmoid(y) * cfg["max_depth"]).permute(0, 2, 3, 1)
