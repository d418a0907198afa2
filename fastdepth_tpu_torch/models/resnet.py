"""ResNet encoders and the ResNet depth models — counterpart of
``fastdepth_tpu/models/resnet.py`` (reference models.py:363-418
``ResNet`` + registry decoder, :462-556 ``ResNetSkipAdd``, :558-652
``ResNetSkipConcat``).

torchvision's topology: conv1 7x7 s2 p3 -> BN -> ReLU -> max pool 3x3 s2
p1 -> layer1..4 of BasicBlock (18/34) or Bottleneck (50/101/152, stride
on the 3x3 ``conv2``); then ``conv2``, a 1x1 conv to 1024 with a bias and
no BatchNorm.  The skip decoders are dense 5x5 stages fed the taps
``[x1, x3, x4, x5, x6]`` (the stem's output and each layer's); they need
BasicBlock widths unless ``ModelConfig.bottleneck_skips`` adds 1x1 + BN
tap projections (add) or widens the stages to the taps (concat).

The additive skip is added BEFORE each upsample, and at stage 5 before
the conv (models.py:534-556); MobileNet's comes after the upsample, so
the two families share no decoder code.

Under a ``space`` level (a height-sharded forward, ``parallel/
spatial.py``) every activation, the taps too, is this rank's rows of
its level: the stem, the max pool and each block's strided conv step
the level down, each decoder upsample steps it up.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.models import decoders as D
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.parallel import spatial as S

# torchvision ResNet block counts and Bottleneck depths
RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}
STAGE_WIDTHS = (64, 128, 256, 512)

# additive-skip stage output widths (models.py:502-507), each with the tap
# it receives, in forward order
_ADD_TAP_PLAN = (("x6", 512), ("x5", 256), ("x4", 128), ("x3", 64), ("x1", 64))


def resnet_depth(cfg: ModelConfig) -> int:
    return int(cfg.encoder.replace("resnet", ""))


def _block(cin: int, width: int, stride: int, bottleneck: bool, folded: bool) -> nn.ModuleDict:
    cout = width * 4 if bottleneck else width
    if bottleneck:
        p = nn.ModuleDict({
            "conv1": L.conv_leaf((width, cin, 1, 1), folded=folded),
            "conv2": L.conv_leaf((width, width, 3, 3), folded=folded),
            "conv3": L.conv_leaf((cout, width, 1, 1), folded=folded),
        })
    else:
        p = nn.ModuleDict({
            "conv1": L.conv_leaf((cout, cin, 3, 3), folded=folded),
            "conv2": L.conv_leaf((cout, cout, 3, 3), folded=folded),
        })
    if stride != 1 or cin != cout:
        p["downsample"] = L.conv_leaf((cout, cin, 1, 1), folded=folded)
    return p


def make_resnet_encoder(layers: int, in_channels: int = 3, *,
                        folded: bool = False) -> nn.ModuleDict:
    """The encoder's tree (``conv1``, ``layer1..4.block{b}``), zero-filled."""
    if layers not in RESNET_LAYERS:
        raise ValueError(f"resnet{layers} not defined; options {sorted(RESNET_LAYERS)}")
    bottleneck = layers in BOTTLENECK
    params = nn.ModuleDict({"conv1": L.conv_leaf((64, in_channels, 7, 7), folded=folded)})
    cin = 64
    for s, (width, n) in enumerate(zip(STAGE_WIDTHS, RESNET_LAYERS[layers]), start=1):
        stage = nn.ModuleDict()
        for b in range(n):
            stage[f"block{b}"] = _block(cin, width, 2 if (b == 0 and s > 1) else 1,
                                        bottleneck, folded)
            cin = width * 4 if bottleneck else width
        params[f"layer{s}"] = stage
    return params


def _apply_block(x, p, stride, bottleneck, *, train, stats, path, space=None):
    """One block; ``space``: the level of ``x``, and the block's output
    is at ``space.down(stride=stride)`` (the strided conv and the 1x1
    ``downsample`` land on the same rows, so the residual add is local)."""
    kw = dict(train=train, stats=stats)
    out = space and space.down(stride=stride)
    if bottleneck:  # the stride sits on the 3x3 conv2 (torchvision v1.5)
        y = L.apply_conv_bn(x, p["conv1"], path=path + ("conv1",), space=space, **kw)
        y = L.apply_conv_bn(y, p["conv2"], stride=stride, path=path + ("conv2",), space=space,
                            **kw)
    else:
        y = L.apply_conv_bn(x, p["conv1"], stride=stride, path=path + ("conv1",), space=space,
                            **kw)
    idn = x
    if "downsample" in p:
        idn = L.apply_conv_bn(x, p["downsample"], stride=stride, act=None,
                              path=path + ("downsample",), space=space, **kw)
    last = "conv3" if bottleneck else "conv2"
    # relu(y + idn) in the last conv's epilogue
    return L.apply_conv_bn(y, p[last], residual=idn, path=path + (last,), space=out, **kw)


def _stride(s: int, b: int) -> int:
    """Block ``b`` of layer ``s``'s stride: 2 on the first block of layers 2-4."""
    return 2 if (b == 0 and s > 1) else 1


def apply_resnet_encoder(params: nn.ModuleDict, x: torch.Tensor, layers: int, *,
                         train: bool = False, stats: Optional[L.StatsDict] = None,
                         space: Optional[S.Level] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Channels_last NCHW -> (final features, [x1, x3, x4, x5, x6]), the
    skip taps of ResNetSkipAdd/Concat (reference models.py:515-531);
    statistics under ``('conv1', 'bn')``, ``('layer1', 'block0', 'conv1',
    'bn')``.  ``space``: the level of ``x`` in a height-sharded forward;
    the features and the taps are then this rank's rows of their levels
    (:func:`output_level`).  The pass is one ``engine/profiler.ENCODER``
    span."""
    bottleneck = layers in BOTTLENECK
    with P.annotate(P.ENCODER):
        x1 = L.apply_conv_bn(x, params["conv1"], stride=2, padding=3, train=train,
                             stats=stats, path=("conv1",), space=space)
        space = space and space.down(7, 2, 3)
        y = S.max_pool_3x3_s2(x1, space)
        space = space and space.down()
        taps = [x1]
        for s, n in enumerate(RESNET_LAYERS[layers], start=1):
            stage = params[f"layer{s}"]
            for b in range(n):
                y = _apply_block(y, stage[f"block{b}"], _stride(s, b), bottleneck, train=train,
                                 stats=stats, path=(f"layer{s}", f"block{b}"), space=space)
                space = space and space.down(stride=_stride(s, b))
            taps.append(y)
    return y, taps


def output_level(level: Optional[S.Level]) -> Optional[S.Level]:
    """The encoder's output level of a height-sharded forward whose input
    has ``level`` (None stays None): the stem, the pool and layers 2-4's
    strides."""
    if level is not None:
        level = level.down(7, 2, 3)
        for _ in range(4):  # the pool, layers 2-4
            level = level.down()
    return level


def _tap_widths(layers: int) -> Tuple[int, ...]:
    """(x1, x3, x4, x5, x6) channel widths; Bottleneck stages emit 4x."""
    mult = 4 if layers in BOTTLENECK else 1
    return (64,) + tuple(w * mult for w in STAGE_WIDTHS)


def make_resnet_depth(cfg: ModelConfig, *, folded: bool = False) -> nn.ModuleDict:
    """ResNet / ResNetSkipAdd / ResNetSkipConcat trees, zero-filled, shaped
    like the JAX ``init_resnet_depth``'s."""
    layers = resnet_depth(cfg)
    encoder = make_resnet_encoder(layers, cfg.in_channels, folded=folded)
    params = nn.ModuleDict({
        "encoder": encoder,
        # nn.Conv2d(num_channels, 1024, 1): a bias, no BatchNorm
        # (models.py:399, 498), so {'w','b'} folded or not
        "conv2": L.conv_leaf((1024, 2048 if layers in BOTTLENECK else 512, 1, 1), folded=True),
    })
    if cfg.skip is None:
        params["decoder"] = D.make_decoder(cfg.decoder, in_channels=1024,
                                           channels=cfg.decoder_channels, folded=folded)
        return params
    x1w, x3w, x4w, x5w, x6w = _tap_widths(layers)
    if layers in BOTTLENECK and not cfg.bottleneck_skips:
        # the JAX guard for callers that bypass ModelConfig.validate()
        raise ValueError(
            f"skip decoders support BasicBlock ResNets (18/34) only; "
            f"got {cfg.encoder!r} (Bottleneck tap widths don't match; "
            f"set bottleneck_skips=True for the projected extension)")
    if cfg.skip == "add":
        specs = [(1024, 512), (512, 256), (256, 128), (128, 64), (64, 32)]
        proj = {name: (tw, dw) for (name, dw), tw in zip(_ADD_TAP_PLAN, (x6w, x5w, x4w, x3w, x1w))
                if tw != dw}
    else:
        specs = [(1024, 512), (512 + x5w, 256), (256 + x4w, 128), (128 + x3w, 64),
                 (64 + x1w, 32)]
        proj = {}
    decoder = nn.ModuleDict()
    for i, (cin, cout) in enumerate(specs, start=1):
        decoder[f"decode_conv{i}"] = nn.ModuleDict({
            "conv": L.conv_leaf((cout, cin, 5, 5), folded=folded)})
    decoder["decode_conv6"] = nn.ModuleDict({"pw": L.conv_leaf((1, 32, 1, 1), folded=folded)})
    if proj:  # in sorted key order, as the JAX tree's
        decoder["skip_proj"] = nn.ModuleDict({
            name: L.conv_leaf((dw, tw, 1, 1), folded=folded)
            for name, (tw, dw) in sorted(proj.items())})
    params["decoder"] = decoder
    return params


def apply_resnet_depth(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                       train: bool = False, stats: Optional[L.StatsDict] = None,
                       space: Optional[S.Partition] = None) -> torch.Tensor:
    """NHWC forward; statistics under ``('encoder', ...)`` and
    ``('decoder', ...)`` as in JAX.  ``space``: the forward is
    height-sharded over that partition; ``x`` and the result hold this
    rank's rows of the image (``parallel.spatial.input_level``).  All
    after the encoder, the bridge 1x1 on, is one
    ``engine/profiler.DECODER`` span."""
    layers = resnet_depth(cfg)
    lv = S.input_level(space, x, cfg)
    feats, taps = apply_resnet_encoder(
        params["encoder"], B.from_nhwc(x), layers, train=train,
        stats=L.sub_stats(stats, "encoder"), space=lv)
    with P.annotate(P.DECODER):
        return _apply_resnet_decoder(params, feats, taps, cfg, train=train, stats=stats,
                                     lv=output_level(lv))


def _apply_resnet_decoder(params, feats, taps, cfg, *, train, stats, lv):
    """:func:`apply_resnet_depth` after the encoder: the bridge 1x1 to
    1024, the decoder levels and the head, from the encoder's features
    and taps at ``lv``, the encoder's output level (None unsharded)."""
    x1, x3, x4, x5, x6 = taps
    x7 = L.apply_conv_bn(feats, params["conv2"], act=None)  # 1x1: local
    dec = params["decoder"]
    if cfg.skip is None:
        return B.to_nhwc(D.apply_decoder(dec, cfg.decoder, x7, train=train,
                                         stats=L.sub_stats(stats, "decoder"), space=lv))

    def dc(i, v):
        p = dec[f"decode_conv{i}"]
        key = "conv" if "conv" in p else "pw"
        return L.apply_conv_bn(v, p[key], train=train, stats=stats,
                               path=("decoder", f"decode_conv{i}", key), space=lv)

    def up(v):
        nonlocal lv
        v, lv = S.upsample(v, lv)
        return v

    if cfg.skip == "add":
        proj = dec["skip_proj"] if "skip_proj" in dec else {}

        def tap(name, v):
            # Bottleneck extension: a linear 1x1 + BN onto the add width
            if name not in proj:
                return v
            return L.apply_conv_bn(v, proj[name], act=None, train=train, stats=stats,
                                   path=("decoder", "skip_proj", name), space=lv)

        # models.py:534-556: add before the upsample; at stage 5 before the conv
        y = up(dc(1, x7) + tap("x6", x6))
        y = up(dc(2, y) + tap("x5", x5))
        y = up(dc(3, y) + tap("x4", x4))
        y = up(dc(4, y) + tap("x3", x3))
        y = up(dc(5, y + tap("x1", x1)))
        return B.to_nhwc(dc(6, y))
    # concat: models.py:630-652
    y = up(dc(1, x7))
    for i, t in ((2, x5), (3, x4), (4, x3), (5, x1)):
        y = up(dc(i, torch.cat([y, t], dim=1)))
    return B.to_nhwc(dc(6, y))
