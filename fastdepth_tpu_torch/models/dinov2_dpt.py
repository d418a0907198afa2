"""Depth Anything V2 (Yang et al., NeurIPS 2024, arXiv:2406.09414), its
metric-depth form: a DINOv2 ViT encoder (Oquab et al., arXiv:2304.07193;
no register tokens) and a DPT head (Ranftl et al., ICCV 2021,
arXiv:2103.13413), as github.com/DepthAnything/Depth-Anything-V2's
``metric_depth/`` builds them.  The port's fourth family, with no
counterpart in the JAX package.

Encoder (DA-V2's ``DINOv2(..., img_size=518, patch_size=14,
init_values=1.0)``): the frame, already in [0, 1], normalised by
ImageNet's mean and std; a 14 x 14 stride-14 conv to ``dim`` channels;
the class token prepended and the position embedding added (sized for
``output_size``: at DA-V2's 518 x 518 the published ``(1, 1370, 1024)``,
so nothing is interpolated); then ``depth`` pre-LN blocks,

    x += gamma1 * proj(attn(LN1(x)))      attn: softmax(q k^T / sqrt(64)) v
    x += gamma2 * fc2(GELU(fc1(LN2(x))))   GELU: the exact (erf) form

(LayerNorm eps 1e-6, one qkv linear with a bias, heads of 64).  The
outputs of the preset's four ``taps`` blocks go through the final
LayerNorm and lose their class token.

DPT head (``DPTHead(features, out_channels, use_bn=False,
use_clstoken=False)``): each tap as a ``(B, dim, H/14, W/14)`` map, a
1 x 1 conv to its ``out_channels``, then a resize: a 4 x 4 stride-4 and
a 2 x 2 stride-2 transposed conv, the identity, a 3 x 3 stride-2 conv;
then a 3 x 3 conv without bias to ``features`` (``layer*_rn``).  Fusion
blocks ``F(a, b, size) = conv1x1(resize(RCU2(a + RCU1(b)), size))``,
``RCU(x) = x + conv3(relu(conv3(relu(x))))``, bilinear resizes with
``align_corners=True`` (x2 where no size is given), from level 4 down;
then a 3 x 3 conv to ``features / 2``, a bilinear resize to the frame,
a 3 x 3 conv to 32, ReLU, a 1 x 1 conv to 1, sigmoid, times
``max_depth``.

The tree (``make_dinov2_dpt``) has no BatchNorm: ``Model.load`` sees a
folded tree, and folding leaves it as it is.  Inference only: no
``train``, no ``space`` axis (attention is global; no halo covers it),
and no K1 / K4 path, so ``engine/aot`` runs it straight.  Attention runs
through ``F.scaled_dot_product_attention``, each call one
``engine/profiler.ATTENTION`` span.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.ops import init as I

FAMILY = "dinov2_dpt"
DECODER = "dpt"
PATCH = 14
LN_EPS = 1e-6
HEAD_DIM = 64
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HEAD_HIDDEN = 32  # the last conv's input width (DPTHead's head_features_2)
RESIZE_LIMIT = 2 ** 31 - 1  # INT_MAX: upsample_bilinear2d's NHWC CUDA kernel stays under it


class Preset(NamedTuple):
    """A DA-V2 encoder's published widths (``depth_anything_v2/dpt.py``'s
    ``model_configs`` and ``intermediate_layer_idx``)."""

    dim: int
    depth: int
    mlp: int
    taps: Tuple[int, ...]
    features: int
    out_channels: Tuple[int, ...]
    max_depth: float  # metres: the metric Hypersim models' 20
    image_size: int  # DA-V2's training crop

    @property
    def heads(self) -> int:
        return self.dim // HEAD_DIM


PRESETS = {
    "dinov2_vits14": Preset(384, 12, 1536, (2, 5, 8, 11), 64, (48, 96, 192, 384), 20.0, 518),
    "dinov2_vitl14": Preset(1024, 24, 4096, (4, 11, 17, 23), 256, (256, 512, 1024, 1024),
                            20.0, 518),
}


# why a height-sharded forward (the 'space' mesh axis) cannot run it
WHOLE = "whole on each rank: its attention is global, so the 'space' mesh axis cannot shard it"


def is_family(cfg: ModelConfig) -> bool:
    return cfg.encoder in PRESETS


def refusal(what: str) -> str:
    """The message for what the family does not run."""
    return f"the {FAMILY} family (DINOv2 ViT + DPT head) runs {what}"


def preset(cfg: ModelConfig) -> Preset:
    """The encoder's preset, after the config is checked against it."""
    p = PRESETS[cfg.encoder]
    if cfg.decoder != DECODER or cfg.skip is not None:
        raise ValueError(f"{refusal('a dpt decoder without skips')}; got "
                         f"decoder={cfg.decoder!r} skip={cfg.skip!r}")
    if tuple(cfg.decoder_channels) != p.out_channels:
        raise ValueError(f"{refusal(f'{cfg.encoder} with the head widths {p.out_channels}')}; "
                         f"got decoder_channels={tuple(cfg.decoder_channels)}")
    if cfg.in_channels != 3 or any(s <= 0 or s % PATCH for s in cfg.output_size):
        raise ValueError(f"{refusal(f'RGB frames whose sides are multiples of {PATCH}')}; got "
                         f"output_size={tuple(cfg.output_size)} in_channels={cfg.in_channels}")
    return p


def config(encoder: str) -> ModelConfig:
    """The published model of ``encoder`` at DA-V2's 518 x 518."""
    p = PRESETS[encoder]
    return ModelConfig(encoder=encoder, decoder=DECODER, skip=None,
                       decoder_channels=p.out_channels,
                       output_size=(p.image_size, p.image_size))


def make_dinov2_dpt(cfg: ModelConfig, *, folded: bool = True) -> nn.ModuleDict:
    """The zero-filled tree; ``folded`` is ignored (no BatchNorm)."""
    p = preset(cfg)
    h, w = (s // PATCH for s in cfg.output_size)
    d, f, oc = p.dim, p.features, p.out_channels

    def conv(cout, cin, k, bias=True):
        return L.conv_leaf((cout, cin, k, k), folded=True, bias=bias)

    def block():
        return nn.ModuleDict({
            "norm1": L.LayerNorm(d), "qkv": L.Linear(d, 3 * d), "proj": L.Linear(d, d),
            "ls1": L.LayerScale(d), "norm2": L.LayerNorm(d), "fc1": L.Linear(d, p.mlp),
            "fc2": L.Linear(p.mlp, d), "ls2": L.LayerScale(d)})

    encoder = nn.ModuleDict({"normalize": _Normalize(), "patch_embed": conv(d, 3, PATCH),
                             "tokens": L.Tokens(h * w, d)})
    encoder.update({f"block{i}": block() for i in range(p.depth)})
    encoder["norm"] = L.LayerNorm(d)

    def rcu():
        return nn.ModuleDict({"conv1": conv(f, f, 3), "conv2": conv(f, f, 3)})

    decoder = nn.ModuleDict()
    for i, c in enumerate(oc, start=1):
        decoder[f"project{i}"] = conv(c, d, 1)
    decoder["resize1"] = L.conv_leaf((oc[0], oc[0], 4, 4), folded=True, transpose=True)
    decoder["resize2"] = L.conv_leaf((oc[1], oc[1], 2, 2), folded=True, transpose=True)
    decoder["resize4"] = conv(oc[3], oc[3], 3)
    for i, c in enumerate(oc, start=1):
        decoder[f"layer{i}_rn"] = conv(f, c, 3, bias=False)
    for j in range(1, 5):  # refinenet4 has no first unit: nothing feeds it
        decoder[f"refine{j}"] = nn.ModuleDict(
            {**({"rcu1": rcu()} if j < 4 else {}), "rcu2": rcu(), "out": conv(f, f, 1)})
    decoder["out_conv1"] = conv(f // 2, f, 3)
    decoder["out_conv2"] = conv(HEAD_HIDDEN, f // 2, 3)
    decoder["out_conv3"] = conv(1, HEAD_HIDDEN, 1)
    return nn.ModuleDict({"encoder": encoder, "decoder": decoder})


class _Normalize(nn.Module):
    """ImageNet's mean and std as non-persistent buffers: out of the
    state dict, they follow the tree's ``.to()``, so a CUDA graph's
    capture finds them on the card."""

    def __init__(self):
        super().__init__()
        for name, v in (("mean", MEAN), ("std", STD)):
            self.register_buffer(name, torch.tensor(v).view(1, 3, 1, 1), persistent=False)


@torch.no_grad()
def init_dinov2_dpt(params: nn.ModuleDict, generator: torch.Generator) -> nn.ModuleDict:
    """DINOv2's init (its ``init_weights`` and ``init_weights_vit_timm``)
    in place, in module order: linears trunc-normal with std 0.02 and a
    zero bias, the position embedding trunc-normal 0.02, the class token
    normal 1e-6, LayerScale 1.0 (DA-V2's ``init_values``), LayerNorm the
    identity; every conv, the patch embedding and DPT's too, the port's
    He-normal with a zero bias (``ops/init.he_normal_conv``).  Returns
    ``params``."""
    for m in params.modules():
        if isinstance(m, L.Linear):
            m.w.data = I.trunc_normal(m.w.shape, 0.02, generator)
            m.b.data.zero_()
        elif isinstance(m, L.Tokens):
            m.pos.data = I.trunc_normal(m.pos.shape, 0.02, generator)
            m.cls.data = torch.randn(m.cls.shape, generator=generator) * 1e-6
        elif isinstance(m, L.LayerScale):
            m.gamma.data.fill_(1.0)
        elif isinstance(m, L.LayerNorm):
            m.scale.data.fill_(1.0)
            m.bias.data.zero_()
        elif isinstance(m, L.ConvBN):
            m.w.data = I.he_normal_conv(m.w.shape, generator)
            if m.b is not None:
                m.b.data.zero_()
    return params


def _attention(p: nn.ModuleDict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head self-attention of ``x`` (B, N, D): one qkv GEMM, the
    attention product (one ``ATTENTION`` span), the output projection."""
    b, n, d = x.shape
    q, k, v = L.apply_linear(x, p["qkv"]).view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    with P.annotate(P.ATTENTION):
        y = F.scaled_dot_product_attention(q, k, v)
    return L.apply_linear(y.transpose(1, 2).reshape(b, n, d), p["proj"])


def _block(p: nn.ModuleDict, x: torch.Tensor, heads: int) -> torch.Tensor:
    x = torch.addcmul(x, p["ls1"].gamma,
                      _attention(p, L.apply_layer_norm(x, p["norm1"], LN_EPS), heads))
    h = F.gelu(L.apply_linear(L.apply_layer_norm(x, p["norm2"], LN_EPS), p["fc1"]))
    return torch.addcmul(x, p["ls2"].gamma, L.apply_linear(h, p["fc2"]))


def apply_encoder(params: nn.ModuleDict, x: torch.Tensor, pre: Preset) -> list:
    """Channels_last NCHW frames in [0, 1] -> the normed taps, each a
    channels_last ``(B, dim, H / 14, W / 14)`` map.  One
    ``engine/profiler.ENCODER`` span."""
    with P.annotate(P.ENCODER):
        norm = params["normalize"]
        y = L.apply_conv_bn((x - norm.mean) / norm.std, params["patch_embed"], stride=PATCH,
                            padding=0, act=None)
        b, d, h, w = y.shape
        tokens = params["tokens"]
        y = torch.cat([tokens.cls.expand(b, 1, d), B.to_nhwc(y).reshape(b, h * w, d)], dim=1)
        y = y + tokens.pos
        taps = []
        for i in range(pre.depth):
            y = _block(params[f"block{i}"], y, pre.heads)
            if i in pre.taps:
                t = L.apply_layer_norm(y, params["norm"], LN_EPS)[:, 1:]
                taps.append(t.reshape(b, h, w, d).permute(0, 3, 1, 2))
    return taps


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, ``align_corners=True``.  CUDA's channels_last kernel
    refuses an output of :data:`RESIZE_LIMIT` elements or more (b64's
    ``(64, 128, 518, 518)`` before ``out_conv2`` is 2.2e9), so a larger
    one is written in batch slices into one output."""
    size = tuple(int(s) for s in size)
    per = x.shape[1] * size[0] * size[1]
    if x.shape[0] * per < RESIZE_LIMIT:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty((x.shape[0], x.shape[1], *size), dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    step = max(1, (RESIZE_LIMIT - 1) // per)
    for i in range(0, x.shape[0], step):
        torch.ops.aten.upsample_bilinear2d.out(x[i:i + step], size, True, out=out[i:i + step])
    return out


def _rcu(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    y = L.apply_conv_bn(torch.relu(x), p["conv1"], act=torch.relu)
    return L.apply_conv_bn(y, p["conv2"], act=None, residual=x)


def _fuse(p: nn.ModuleDict, a: torch.Tensor, b: Optional[torch.Tensor], size) -> torch.Tensor:
    y = a if b is None else a + _rcu(p["rcu1"], b)
    y = _rcu(p["rcu2"], y)
    y = _resize(y, size if size is not None else [2 * s for s in y.shape[2:]])
    return L.apply_conv_bn(y, p["out"], act=None)


def apply_head(dec: nn.ModuleDict, taps: list, out_hw, max_depth: float) -> torch.Tensor:
    """The DPT head on the four taps -> ``(B, 1, H, W)`` metric depth."""
    levels = []
    for i, t in enumerate(taps, start=1):
        y = L.apply_conv_bn(t, dec[f"project{i}"], act=None)
        if i in (1, 2):
            y = L.apply_conv_bn(y, dec[f"resize{i}"], stride=4 if i == 1 else 2, act=None)
        elif i == 4:
            y = L.apply_conv_bn(y, dec["resize4"], stride=2, act=None)
        levels.append(L.apply_conv_bn(y, dec[f"layer{i}_rn"], act=None))
    l1, l2, l3, l4 = levels
    path = _fuse(dec["refine4"], l4, None, l3.shape[2:])
    path = _fuse(dec["refine3"], path, l3, l2.shape[2:])
    path = _fuse(dec["refine2"], path, l2, l1.shape[2:])
    path = _fuse(dec["refine1"], path, l1, None)
    y = _resize(L.apply_conv_bn(path, dec["out_conv1"], act=None), out_hw)
    y = L.apply_conv_bn(y, dec["out_conv2"], act=torch.relu)
    return torch.sigmoid(L.apply_conv_bn(y, dec["out_conv3"], act=None)) * max_depth


def apply_dinov2_dpt(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                     train: bool = False, stats: Optional[L.StatsDict] = None,
                     space=None) -> torch.Tensor:
    """NHWC frames in [0, 1] -> NHWC ``(B, H, W, 1)`` depth in metres.
    The ViT is one ``engine/profiler.ENCODER`` span, the head one
    ``DECODER`` span."""
    if train or stats is not None:
        raise ValueError(refusal("for inference only; train=True is refused"))
    if space is not None:
        raise ValueError(refusal(WHOLE))
    pre = preset(cfg)
    if tuple(x.shape[1:3]) != tuple(cfg.output_size):
        raise ValueError(f"{FAMILY}: the tree's position embedding is sized for "
                         f"{tuple(cfg.output_size)}, got frames {tuple(x.shape[1:3])}")
    taps = apply_encoder(params["encoder"], B.from_nhwc(x), pre)
    with P.annotate(P.DECODER):
        depth = apply_head(params["decoder"], taps, cfg.output_size, pre.max_depth)
    return B.to_nhwc(depth)

