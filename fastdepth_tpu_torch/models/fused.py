"""FastDepth forwards with the fused decoder and the head-commute rewrite —
counterpart of ``fastdepth_tpu/models/fused.py``.

* :func:`apply_fastdepth_fused`: the encoder through cuDNN, each decoder
  level 1-5 as ONE launch of K1 (``ops/cuda/fused_decoder.py``), then the
  1x1 head as one launch of K4 (``ops/cuda/head.py``; the JAX package ran
  the head through XLA, because Mosaic's compile helper crashed on it).
* :func:`apply_fastdepth_fused_v2` and :func:`apply_fastdepth_fused_v3`:
  the same forward with the levels through K2 (image groups) or K3
  (persistent, double-buffered), at the JAX forwards' per-level block
  batches, then K4.
* :func:`apply_fastdepth_opt`: plain PyTorch, the 1x1 head commuted
  before the final nearest x2 (exact: the head is a per-pixel affine +
  ReLU).
* :func:`apply_fastdepth_mixed`: each decoder level on the implementation
  a tuning record names for it (``engine/autotune.py``): ``'pallas'`` is
  one launch of K1, ``'xla'`` the plain cuDNN/ATen stage; the head through
  K4.

``space=`` (a ``parallel.spatial.Partition``) runs the fused, the mixed
and the opt forward height-sharded: every conv of the encoder and the
decoder with its halo rows exchanged (``parallel/spatial.py``), each K1
level as one launch in its row-window mode on this rank's rows, the head
through K4 on the local rows.

All need BN-folded params (``Model.fold``); the fused forwards also read
the kernel weight layouts that ``Model.fold`` derives
(:func:`attach_kernel_weights`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.models import mobilenet as MN
from fastdepth_tpu_torch.models.fastdepth import SKIP_AFTER, SKIP_TAPS
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.ops.cuda.fused_decoder import fused_decoder_stage, kernel_weights
from fastdepth_tpu_torch.ops.cuda.fused_decoder_hwbc import fused_decoder_stage_hwbc
from fastdepth_tpu_torch.ops.cuda.fused_decoder_v3 import fused_decoder_stage_v3
from fastdepth_tpu_torch.ops.cuda.head import pointwise_head
from fastdepth_tpu_torch.parallel import spatial as S

# images per block of each decoder level, as the JAX forwards set them
# (fastdepth_tpu/models/fused.py, apply_fastdepth_fused_v2 / _v3)
V2_BLOCK_BATCHES = {1: 8, 2: 8, 3: 4, 4: 2, 5: 1}
V3_BLOCK_BATCHES = {1: 8, 2: 4, 3: 2, 4: 1, 5: 1}

_NNCONV_NAMES = frozenset(f"nnconv{k}{dw}" for k in (3, 5, 7, 9) for dw in ("", "dw"))


def supports_opt(cfg: ModelConfig) -> bool:
    """True when :func:`apply_fastdepth_opt` covers this architecture
    (MobileNet encoder + nearest-upsample NNConv decoder family)."""
    return cfg.encoder == "mobilenet" and cfg.decoder in _NNCONV_NAMES


def supports_fused(cfg: ModelConfig) -> bool:
    """True when K1's stage shape (5x5 dw + 1x1 pw + skip-add) covers this
    architecture: MobileNet nnconv5dw with additive skips."""
    return (cfg.encoder == "mobilenet" and cfg.skip == "add"
            and cfg.decoder in _NNCONV_NAMES
            and cfg.decoder_depthwise and cfg.decoder_kernel == 5)


def tree_has_bn(params: nn.Module) -> bool:
    """True if any unfolded BatchNorm remains — the opt/fused paths need
    folded ``{'w','b'}`` leaves."""
    return any(name.rsplit(".", 1)[-1] == "bn" for name, _ in params.named_modules())


def attach_kernel_weights(params: nn.ModuleDict) -> None:
    """Give the folded decoder its weights in the kernels' layouts, as
    non-persistent buffers: ``k1_dw (25, C)`` and ``k1_pw (C, Cout)`` on
    each ``decoder.decode_conv{1..5}`` (K1-K3), ``k4_w (C,)`` on
    ``decoder.decode_conv6`` (K4).  Derived once, here, instead of on
    every call; they follow the tree through ``.to()`` and stay out of the
    state dict."""
    dec = params["decoder"]
    for i in range(1, 6):
        p = dec[f"decode_conv{i}"]
        dw, pw = kernel_weights(p["dw"].w, p["pw"].w)
        p.register_buffer("k1_dw", dw, persistent=False)
        p.register_buffer("k1_pw", pw, persistent=False)
    head = dec["decode_conv6"]
    head.register_buffer("k4_w", head["pw"].w.reshape(-1).contiguous(), persistent=False)


def _fused_forward(params, x, cfg, stage, space=None):
    """Guard + encoder pass, decoder levels 1-5 through
    ``stage(i, y, p, skip, level)`` (``level`` that of ``y`` under
    ``space``, else None), then the head through K4 (NHWC in and out);
    the levels and the head are one ``engine/profiler.DECODER`` span."""
    if not supports_fused(cfg):
        raise ValueError(
            "fused path supports the MobileNet nnconv5dw skip-add family; "
            f"got encoder={cfg.encoder!r} decoder={cfg.decoder!r} skip={cfg.skip!r}")
    dec = params["decoder"]
    if not hasattr(dec["decode_conv6"], "k4_w"):
        raise ValueError("the fused path needs params from Model.fold "
                         "(folded BN and the kernels' weight layouts)")
    lv = S.input_level(space, x, cfg)
    y, tapped = MN.apply_encoder(params["encoder"], B.from_nhwc(x),
                                 relu6=cfg.encoder_relu6, taps=SKIP_TAPS, space=lv)
    lv = MN.output_level(lv)
    with P.annotate(P.DECODER):
        for i in range(1, 6):
            skip = tapped[SKIP_AFTER[i]] if i in SKIP_AFTER else None
            y = stage(i, y, dec[f"decode_conv{i}"], skip, lv)
            lv = lv and lv.up()
        head = dec["decode_conv6"]
        return B.to_nhwc(pointwise_head(y, head.k4_w, head["pw"].b))


def _k1_stage(i, y, p, skip, level):
    """One decoder level as one launch of K1 (its plain version for a CPU
    tensor); under ``level`` on this rank's tile and row window
    (``parallel.spatial.k1_window``)."""
    window = None
    if level is not None:
        y, window = S.k1_window(y, level)
    return fused_decoder_stage(y, p.k1_dw, p["dw"].b, p.k1_pw, p["pw"].b, skip=skip,
                               window=window)


def _plain_stage(i, y, p, skip, level):
    """One decoder level as plain PyTorch ops (cuDNN/ATen on the card),
    as :func:`apply_fastdepth_opt`'s loop runs it: dw5x5 -> ReLU -> pw1x1
    -> ReLU -> nearest x2 (+ skip); under ``level`` height-sharded."""
    if level is None:
        y = B.relu(B.depthwise_conv2d(y, p["dw"].w, bias=p["dw"].b))
        y = B.relu(B.conv2d(y, p["pw"].w, bias=p["pw"].b))
    else:
        y = B.relu(S.conv2d(y, p["dw"].w, p["dw"].b, level=level, groups=y.shape[1]))
        y = B.relu(S.conv2d(y, p["pw"].w, p["pw"].b, level=level))
    # channels_last for K1 and K4 downstream: a no-op except where a
    # 1x1 level's upsample comes back in the default layout
    y = S.upsample(y, level)[0].contiguous(memory_format=torch.channels_last)
    return y if skip is None else y + skip


def apply_fastdepth_fused(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                          space: Optional[S.Partition] = None) -> torch.Tensor:
    """NHWC forward with decoder levels 1-5 through K1 and the head
    through K4 (their plain versions for CPU tensors).  Params must come
    from ``Model.fold``.  ``space``: height-sharded (module docstring);
    each level's K1 takes this rank's tile and row window
    (``parallel.spatial.k1_window``)."""
    return _fused_forward(params, x, cfg, _k1_stage, space)


MIXED_STAGES = {"pallas": _k1_stage, "xla": _plain_stage}


def apply_fastdepth_mixed(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig,
                          winners: Dict[int, str], *,
                          space: Optional[S.Partition] = None) -> torch.Tensor:
    """Per-level implementation from a tuning record's winner map
    ``{level: 'xla' | 'pallas'}`` (``engine/autotune.load_tuning``), the
    counterpart of the JAX package's ``apply_fastdepth_mixed``: a
    ``'pallas'`` level is one launch of K1, an ``'xla'`` level the plain
    cuDNN/ATen stage, a level the map does not name ``'xla'``; the head
    through K4.  Every stage takes and returns channels_last NCHW, so no
    level pays a layout change.  Params must come from ``Model.fold``.
    ``space``: height-sharded (module docstring).  The JAX forward's
    per-level block batches and ``lax.map`` slices worked around TPU
    compile limits and have no counterpart here."""
    bad = {i: w for i, w in winners.items() if w not in MIXED_STAGES}
    if bad:
        raise ValueError(f"winner map names unknown implementations {bad}; "
                         f"known: {sorted(MIXED_STAGES)}")
    return _fused_forward(params, x, cfg, lambda i, y, p, skip, level: MIXED_STAGES[
        winners.get(i, "xla")](i, y, p, skip, level), space)


def apply_fastdepth_fused_v2(params: nn.ModuleDict, x: torch.Tensor,
                             cfg: ModelConfig) -> torch.Tensor:
    """:func:`apply_fastdepth_fused` with the levels through K2, at
    :data:`V2_BLOCK_BATCHES` images per block."""
    return _fused_forward(params, x, cfg, lambda i, y, p, skip, _: fused_decoder_stage_hwbc(
        y, p.k1_dw, p["dw"].b, p.k1_pw, p["pw"].b, skip=skip,
        block_batch=V2_BLOCK_BATCHES[i]))


def apply_fastdepth_fused_v3(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                             block_batches: Optional[Dict[int, int]] = None) -> torch.Tensor:
    """:func:`apply_fastdepth_fused` with the levels through K3, at
    ``block_batches`` (level -> images per work item; by default
    :data:`V3_BLOCK_BATCHES`)."""
    bbs = block_batches or V3_BLOCK_BATCHES
    return _fused_forward(params, x, cfg, lambda i, y, p, skip, _: fused_decoder_stage_v3(
        y, p.k1_dw, p["dw"].b, p.k1_pw, p["pw"].b, skip=skip, block_batch=bbs[i]))


def apply_fastdepth_opt(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, *,
                        space: Optional[S.Partition] = None) -> torch.Tensor:
    """Plain-PyTorch forward with the head-commute rewrite: the 1x1 head
    (per-pixel affine + ReLU) commutes with nearest duplication, so it
    runs BEFORE the final x2 upsample, on a quarter of the pixels.  Valid
    for the NNConv family (nearest upsample), skip models and plain
    MobileNet + nnconv decoders alike, with folded params.  ``space``:
    height-sharded (module docstring).  The decoder levels and the head
    are one ``engine/profiler.DECODER`` span."""
    if not supports_opt(cfg):
        raise ValueError(
            "opt path supports MobileNet encoders with nnconv decoders; "
            f"got encoder={cfg.encoder!r} decoder={cfg.decoder!r}")
    lv = S.input_level(space, x, cfg)

    def conv(y, w, b, depthwise=False):
        if lv is None:
            return (B.depthwise_conv2d if depthwise else B.conv2d)(y, w, bias=b)
        return S.conv2d(y, w, b, level=lv, groups=y.shape[1] if depthwise else 1)

    feats, tapped = MN.apply_encoder(params["encoder"], B.from_nhwc(x),
                                     relu6=cfg.encoder_relu6,
                                     taps=SKIP_TAPS if cfg.skip else (), space=lv)
    lv = MN.output_level(lv)
    dec = params["decoder"]
    # the skip models name the stages decode_conv1..6 (reference
    # models.py:683-698), the plain ones stage1..5 + final (models/decoders.py)
    skip_naming = "decode_conv1" in dec
    y = feats
    with P.annotate(P.DECODER):
        for i in range(1, 6):
            p = dec[f"decode_conv{i}" if skip_naming else f"stage{i}"]
            if cfg.decoder_depthwise:
                y = B.relu(conv(y, p["dw"].w, p["dw"].b, depthwise=True))
                y = B.relu(conv(y, p["pw"].w, p["pw"].b))
            else:
                y = B.relu(conv(y, p["conv"].w, p["conv"].b))
            if i == 5:
                break  # the head commutes with the final upsample
            y, lv = S.upsample(y, lv)
            if cfg.skip and i in SKIP_AFTER:
                t = tapped[SKIP_AFTER[i]]
                y = y + t if cfg.skip == "add" else torch.cat([y, t], dim=1)
        head = dec["decode_conv6" if skip_naming else "final"]["pw"]
        y = B.relu(B.conv2d(y, head.w, bias=head.b))
        return B.to_nhwc(S.upsample(y, lv)[0])
