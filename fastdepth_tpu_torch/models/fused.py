"""FastDepth forwards with the fused decoder and the head-commute rewrite —
counterpart of ``fastdepth_tpu/models/fused.py``.

* :func:`apply_fastdepth_fused`: the encoder through cuDNN, each decoder
  level 1-5 as ONE launch of K1 (``ops/cuda/fused_decoder.py``), the 1x1
  head as a plain conv (as the JAX package ran it through XLA).
* :func:`apply_fastdepth_opt`: plain PyTorch, the 1x1 head commuted
  before the final nearest x2 (exact: the head is a per-pixel affine +
  ReLU).

Both need BN-folded params (``Model.fold``); the fused forward also reads
the K1 weight layouts that ``Model.fold`` derives (:func:`attach_kernel_weights`).
"""

from __future__ import annotations

import torch
from torch import nn

from fastdepth_tpu.config import ModelConfig
from fastdepth_tpu_torch.models import mobilenet as MN
from fastdepth_tpu_torch.models.fastdepth import SKIP_AFTER, SKIP_TAPS
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.ops.cuda.fused_decoder import fused_decoder_stage, kernel_weights

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
    """Give each folded decoder level 1-5 its weights in K1's layout, as
    non-persistent buffers ``k1_dw (25, C)`` and ``k1_pw (C, Cout)`` on
    ``decoder.decode_conv{i}``: derived once, here, instead of on every
    call; they follow the tree through ``.to()`` and stay out of the
    state dict."""
    for i in range(1, 6):
        p = params["decoder"][f"decode_conv{i}"]
        dw, pw = kernel_weights(p["dw"].w, p["pw"].w)
        p.register_buffer("k1_dw", dw, persistent=False)
        p.register_buffer("k1_pw", pw, persistent=False)


def _fused_preamble(params, x, cfg):
    """Guard + encoder pass: (decoder params, features, {stage: skip})."""
    if not supports_fused(cfg):
        raise ValueError(
            "fused path supports the MobileNet nnconv5dw skip-add family; "
            f"got encoder={cfg.encoder!r} decoder={cfg.decoder!r} skip={cfg.skip!r}")
    feats, tapped = MN.apply_encoder(params["encoder"], B.from_nhwc(x),
                                     relu6=cfg.encoder_relu6, taps=SKIP_TAPS)
    return params["decoder"], feats, {i: tapped[t] for i, t in SKIP_AFTER.items()}


def apply_fastdepth_fused(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """NHWC forward with decoder levels 1-5 through K1 (its plain version
    for CPU tensors).  Params must come from ``Model.fold``."""
    dec, y, skips = _fused_preamble(params, x, cfg)
    for i in range(1, 6):
        p = dec[f"decode_conv{i}"]
        if not hasattr(p, "k1_dw"):
            raise ValueError("the fused path needs params from Model.fold "
                             "(folded BN and K1's weight layouts)")
        y = fused_decoder_stage(y, p.k1_dw, p["dw"].b, p.k1_pw, p["pw"].b,
                                skip=skips.get(i))
    head = dec["decode_conv6"]["pw"]
    return B.to_nhwc(B.relu(B.conv2d(y, head.w, bias=head.b)))


def apply_fastdepth_opt(params: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch forward with the head-commute rewrite: the 1x1 head
    (per-pixel affine + ReLU) commutes with nearest duplication, so it
    runs BEFORE the final x2 upsample, on a quarter of the pixels.  Valid
    for the NNConv family (nearest upsample) with folded params."""
    if not supports_opt(cfg):
        raise ValueError(
            "opt path supports MobileNet encoders with nnconv decoders; "
            f"got encoder={cfg.encoder!r} decoder={cfg.decoder!r}")
    feats, tapped = MN.apply_encoder(params["encoder"], B.from_nhwc(x),
                                     relu6=cfg.encoder_relu6,
                                     taps=SKIP_TAPS if cfg.skip else ())
    dec = params["decoder"]
    y = feats
    for i in range(1, 6):
        p = dec[f"decode_conv{i}"]
        if cfg.decoder_depthwise:
            y = B.relu(B.depthwise_conv2d(y, p["dw"].w, bias=p["dw"].b))
            y = B.relu(B.conv2d(y, p["pw"].w, bias=p["pw"].b))
        else:
            y = B.relu(B.conv2d(y, p["conv"].w, bias=p["conv"].b))
        if i == 5:
            break  # the head commutes with the final upsample
        y = B.upsample_nearest2x(y)
        if cfg.skip and i in SKIP_AFTER:
            t = tapped[SKIP_AFTER[i]]
            y = y + t if cfg.skip == "add" else torch.cat([y, t], dim=1)
    head = dec["decode_conv6"]["pw"]
    y = B.relu(B.conv2d(y, head.w, bias=head.b))
    return B.to_nhwc(B.upsample_nearest2x(y))
