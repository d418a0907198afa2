"""FastDepth: MobileNet encoder + NNConv decoder with skip connections —
counterpart of ``fastdepth_tpu/models/fastdepth.py`` (reference
MobileNetSkipAdd / MobileNetSkipConcat, models.py:654-814), and the plain
MobileNet + registry decoder (reference MobileNet, models.py:420-460).

Encoder taps x1 = conv1, x2 = conv3, x3 = conv5; each decoder stage i in
1..5 runs dw5x5+pw (or a dense kxk conv), then nearest x2, then adds (or
concatenates) x3 / x2 / x1 after stages 2 / 3 / 4; a final pointwise
conv gives one channel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.models import decoders as D
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.models import mobilenet as MN
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.parallel import spatial as S

SKIP_TAPS = (1, 3, 5)  # encoder block indices feeding skips (models.py:714-719)
SKIP_AFTER = {2: 5, 3: 3, 4: 1}  # decoder stage -> encoder tap added after it


def make_fastdepth(cfg: ModelConfig, *, folded: bool = False) -> nn.ModuleDict:
    """The model's parameter tree, zero-filled, shaped like the npz tree
    (mirrors ``init_fastdepth``)."""
    cfg.validate()
    enc, dec = cfg.encoder_channels, cfg.decoder_channels
    if len(dec) != 5:
        raise ValueError(
            f"decoder_channels must have exactly 5 entries, got {len(dec)}: {tuple(dec)}")
    k = cfg.decoder_kernel
    cin = enc[-1]
    decoder = nn.ModuleDict()
    for i, cout in enumerate(dec, start=1):
        if cfg.decoder_depthwise:
            decoder[f"decode_conv{i}"] = nn.ModuleDict({
                "dw": L.conv_leaf((cin, 1, k, k), folded=folded),
                "pw": L.conv_leaf((cout, cin, 1, 1), folded=folded),
            })
        else:
            decoder[f"decode_conv{i}"] = nn.ModuleDict({
                "conv": L.conv_leaf((cout, cin, k, k), folded=folded)})
        cin = cout
        if cfg.skip == "concat" and i in SKIP_AFTER:
            # concat widens the next stage's input (models.py:769-777)
            cin += enc[SKIP_AFTER[i]]
    decoder["decode_conv6"] = nn.ModuleDict({"pw": L.conv_leaf((1, cin, 1, 1), folded=folded)})
    return nn.ModuleDict({
        "encoder": MN.make_encoder(enc, cfg.in_channels, folded=folded),
        "decoder": decoder,
    })


def apply_fastdepth(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                    train: bool = False, stats: Optional[L.StatsDict] = None,
                    space: Optional[S.Partition] = None) -> torch.Tensor:
    """NHWC forward: (N, 224, 224, 3) -> (N, 224, 224, 1).  With ``train``
    every BatchNorm normalises by the batch's moments and records its new
    running statistics into ``stats`` under the JAX package's paths
    (``('encoder', 'conv3', 'dw', 'bn')``, ``('decoder', 'decode_conv2',
    'pw', 'bn')``).  ``space``: the forward is height-sharded over that
    partition; ``x`` and the result hold this rank's rows of the image
    (:func:`parallel.spatial.input_level`)."""
    lv = S.input_level(space, x, cfg)
    feats, tapped = MN.apply_encoder(
        params["encoder"], B.from_nhwc(x), relu6=cfg.encoder_relu6,
        taps=SKIP_TAPS if cfg.skip else (), train=train, stats=L.sub_stats(stats, "encoder"),
        space=lv)
    y = feats
    lv = MN.output_level(lv)
    dec = params["decoder"]
    for i in range(1, 6):
        p = dec[f"decode_conv{i}"]
        path = ("decoder", f"decode_conv{i}")
        if cfg.decoder_depthwise:
            y = L.apply_conv_bn(y, p["dw"], depthwise=True, train=train, stats=stats,
                                path=path + ("dw",), space=lv)
            y = L.apply_conv_bn(y, p["pw"], train=train, stats=stats, path=path + ("pw",),
                                space=lv)
        else:
            y = L.apply_conv_bn(y, p["conv"], train=train, stats=stats, path=path + ("conv",),
                                space=lv)
        y, lv = S.upsample(y, lv)
        # skip fusion AFTER the upsample (models.py:720-729)
        if cfg.skip and i in SKIP_AFTER:
            t = tapped[SKIP_AFTER[i]]
            y = y + t if cfg.skip == "add" else torch.cat([y, t], dim=1)
    return B.to_nhwc(L.apply_conv_bn(y, dec["decode_conv6"]["pw"], train=train, stats=stats,
                                     path=("decoder", "decode_conv6", "pw")))


def make_mobilenet_decoder(cfg: ModelConfig, *, folded: bool = False) -> nn.ModuleDict:
    """Plain MobileNet + registry decoder, no skips: the tree of the JAX
    ``init_mobilenet_decoder``, zero-filled."""
    return nn.ModuleDict({
        "encoder": MN.make_encoder(cfg.encoder_channels, cfg.in_channels, folded=folded),
        "decoder": D.make_decoder(cfg.decoder, in_channels=cfg.encoder_channels[-1],
                                  channels=cfg.decoder_channels, folded=folded),
    })


def apply_mobilenet_decoder(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                            train: bool = False, stats: Optional[L.StatsDict] = None,
                            space: Optional[S.Partition] = None) -> torch.Tensor:
    """NHWC forward of the plain MobileNet + registry decoder; statistics
    under ``('encoder', ...)`` and ``('decoder', 'stage1', ...)``.
    ``space`` as in :func:`apply_fastdepth` (the nnconv decoders only)."""
    lv = S.input_level(space, x, cfg)
    feats, _ = MN.apply_encoder(params["encoder"], B.from_nhwc(x), relu6=cfg.encoder_relu6,
                                train=train, stats=L.sub_stats(stats, "encoder"), space=lv)
    return B.to_nhwc(D.apply_decoder(params["decoder"], cfg.decoder, feats, train=train,
                                     stats=L.sub_stats(stats, "decoder"),
                                     space=MN.output_level(lv)))
