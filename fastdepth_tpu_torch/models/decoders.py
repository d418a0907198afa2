"""The decoder family registry — counterpart of
``fastdepth_tpu/models/decoders.py`` (reference models.py:135-360).

Five styles are 5-stage pyramids ``in -> channels[0..4] -> pointwise(.,
1)``; ``shuffle`` derives every width from ``in_channels // 4**i``
(pixel shuffle divides channels by 4 a stage) and ends in a BARE final
pixel shuffle with no head (reference models.py:296-333):

* ``deconv{k}[dw]``  — stride-2 transposed convs           (models.py:145-180)
* ``upconv``         — zero-unpool + 5x5 conv              (models.py:183-201)
* ``upproj``         — Laina two-branch up-projection      (models.py:203-222)
* ``nnconv{k}[dw]``  — conv then nearest x2 (FastDepth)    (models.py:224-270)
* ``blconv{k}[dw]``  — conv then bilinear x2               (models.py:272-294)
* ``shuffle{k}[dw]`` — pixel shuffle then conv             (models.py:296-333)

Stage trees: dense ``{'conv'}``, depthwise ``{'dw', 'pw'}``, upproj
``{'branch1_conv1', 'branch1_conv2', 'branch2_conv'}``; stages
``stage1..5`` + ``final.pw`` (shuffle: ``conv1..4``).  Activations are
the port's channels_last NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastdepth_tpu_torch.config import DECODER_NAMES, UNPRUNED_DECODER_CHANNELS
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.parallel import spatial as S


def parse_decoder_name(name: str) -> Tuple[str, int, bool]:
    """'nnconv5dw' -> ('nnconv', 5, True) (reference models.py:335-360)."""
    if name not in DECODER_NAMES:
        raise ValueError(f"invalid decoder {name!r}; options: {DECODER_NAMES}")
    dw = name.endswith("dw")
    base = name[:-2] if dw else name
    if base in ("upconv", "upproj"):
        return base, 5, False
    return base[:-1], int(base[-1]), dw


def _make_stage(kind: str, k: int, dw: bool, cin: int, cout: int, folded: bool) -> nn.ModuleDict:
    if kind == "deconv":
        if dw:
            return nn.ModuleDict({
                "dw": L.conv_leaf((cin, 1, k, k), folded=folded, transpose=True, groups=cin),
                "pw": L.conv_leaf((cout, cin, 1, 1), folded=folded),
            })
        return nn.ModuleDict({"conv": L.conv_leaf((cin, cout, k, k), folded=folded,
                                                  transpose=True)})
    if kind == "upconv":
        return nn.ModuleDict({"conv": L.conv_leaf((cout, cin, 5, 5), folded=folded)})
    if kind == "upproj":
        return nn.ModuleDict({
            "branch1_conv1": L.conv_leaf((cout, cin, 5, 5), folded=folded),
            "branch1_conv2": L.conv_leaf((cout, cout, 3, 3), folded=folded),
            "branch2_conv": L.conv_leaf((cout, cin, 5, 5), folded=folded),
        })
    # nnconv / blconv / shuffle share the conv-stage structure
    if dw:
        return nn.ModuleDict({
            "dw": L.conv_leaf((cin, 1, k, k), folded=folded),
            "pw": L.conv_leaf((cout, cin, 1, 1), folded=folded),
        })
    return nn.ModuleDict({"conv": L.conv_leaf((cout, cin, k, k), folded=folded)})


def make_decoder(name: str, in_channels: int = 1024,
                 channels: Sequence[int] = UNPRUNED_DECODER_CHANNELS, *,
                 folded: bool = False) -> nn.ModuleDict:
    """The decoder's parameter tree, zero-filled, shaped like the JAX
    ``init_decoder``'s."""
    kind, k, dw = parse_decoder_name(name)
    params = nn.ModuleDict()
    if kind == "shuffle":
        cin = in_channels
        for i in range(1, 5):
            cin //= 4
            params[f"conv{i}"] = _make_stage("nnconv", k, dw, cin, cin, folded)
        return params
    if len(channels) != 5:
        raise ValueError(
            f"decoder {name!r} takes exactly 5 stage channels, got "
            f"{len(channels)}: {tuple(channels)}")
    cin = in_channels
    for i, cout in enumerate(channels, start=1):
        params[f"stage{i}"] = _make_stage(kind, k, dw, cin, cout, folded)
        cin = cout
    params["final"] = nn.ModuleDict({"pw": L.conv_leaf((1, cin, 1, 1), folded=folded)})
    return params


def _apply_conv_stage(x, p, *, train=False, stats=None, path=(), space=None):
    """conv, or depthwise + pointwise, each with BN + ReLU (reference
    models.py:52-75); the kernel size comes from the weights."""
    if "dw" in p:
        x = L.apply_conv_bn(x, p["dw"], depthwise=True, train=train, stats=stats,
                            path=path + ("dw",), space=space)
        return L.apply_conv_bn(x, p["pw"], train=train, stats=stats, path=path + ("pw",),
                               space=space)
    return L.apply_conv_bn(x, p["conv"], train=train, stats=stats, path=path + ("conv",),
                           space=space)


def apply_decoder(params: nn.ModuleDict, name: str, x: torch.Tensor, *, train: bool = False,
                  stats: Optional[L.StatsDict] = None,
                  space: Optional[S.Level] = None) -> torch.Tensor:
    """The decoder on channels_last NCHW features; ``train`` / ``stats``
    as in ``layers.apply_conv_bn``, paths relative to the decoder
    (``('stage2', 'dw', 'bn')``).  ``space``: the features' level in a
    height-sharded forward; each stage then runs on this rank's rows of
    its level (``parallel/spatial.py``), and so does the result."""
    kind, k, dw = parse_decoder_name(name)
    kw = dict(train=train, stats=stats)
    if kind == "shuffle":
        for i in range(1, 5):
            x = S.pixel_shuffle(x, space)
            space = space and space.up()
            x = _apply_conv_stage(x, params[f"conv{i}"], path=(f"conv{i}",), space=space, **kw)
        return S.pixel_shuffle(x, space)

    for i in range(1, 6):
        p = params[f"stage{i}"]
        path = (f"stage{i}",)
        if kind == "deconv":
            # ConvTranspose2d(k, stride 2, (k-1)//2, output_padding k%2)
            # doubles the size for every k (models.py:145-180)
            tkw = dict(stride=2, padding=(k - 1) // 2, output_padding=k % 2, space=space, **kw)
            space = space and space.up()
            if dw:
                x = L.apply_conv_bn(x, p["dw"], path=path + ("dw",), **tkw)
                x = L.apply_conv_bn(x, p["pw"], path=path + ("pw",), space=space, **kw)
            else:
                x = L.apply_conv_bn(x, p["conv"], path=path + ("conv",), **tkw)
        elif kind == "upconv":
            x = S.unpool_zero(x, space)
            space = space and space.up()
            x = L.apply_conv_bn(x, p["conv"], path=path + ("conv",), space=space, **kw)
        elif kind == "upproj":
            x = S.unpool_zero(x, space)
            space = space and space.up()
            b1 = L.apply_conv_bn(x, p["branch1_conv1"], path=path + ("branch1_conv1",),
                                 space=space, **kw)
            b2 = L.apply_conv_bn(x, p["branch2_conv"], act=None, path=path + ("branch2_conv",),
                                 space=space, **kw)
            # relu(b1 + b2) in branch1_conv2's epilogue
            x = L.apply_conv_bn(b1, p["branch1_conv2"], residual=b2,
                                path=path + ("branch1_conv2",), space=space, **kw)
        elif kind == "nnconv":
            x, space = S.upsample(_apply_conv_stage(x, p, path=path, space=space, **kw), space)
        else:  # blconv
            x = S.upsample_bilinear2x(_apply_conv_stage(x, p, path=path, space=space, **kw),
                                      space)
            space = space and space.up()
    return L.apply_conv_bn(x, params["final"]["pw"], path=("final", "pw"), space=space, **kw)
