"""Model registry: config -> Model, and name-string parsing — counterpart
of ``fastdepth_tpu/models/registry.py``.

The port covers the MobileNet skip family (MobileNetSkipAdd/Concat with
an NNConv decoder, pruned or not).  Plain MobileNet + registry decoder
models and the ResNet family come with ROADMAP item A11.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from fastdepth_tpu_torch.config import (
    FASTDEPTH_PRUNED,
    FASTDEPTH_UNPRUNED,
    ModelConfig,
    PRUNED_DECODER_CHANNELS,
    PRUNED_ENCODER_CHANNELS,
)
from fastdepth_tpu_torch.models import fastdepth as FD
from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import init as I


def _channels_last(params: nn.ModuleDict) -> nn.ModuleDict:
    for m in params.modules():
        if isinstance(m, L.ConvBN):
            m.w.data = m.w.data.contiguous(memory_format=torch.channels_last)
    return params


@dataclasses.dataclass(frozen=True)
class Model:
    """A model handle: its config, and the functions that build, fold and
    run its parameter tree."""

    config: ModelConfig

    def load(self, state_dict: Dict[str, torch.Tensor], *,
             device: Union[str, torch.device] = "cpu") -> nn.ModuleDict:
        """The parameter tree holding ``state_dict`` (from
        ``checkpoint.params_from_jax``), folded or not as the state dict
        is, conv weights channels_last, on ``device``.  Every key must
        match (strict load)."""
        folded = not any(".bn." in k for k in state_dict)
        params = FD.make_fastdepth(self.config, folded=folded)
        params.load_state_dict(state_dict, strict=True)
        return _channels_last(params).to(device)

    def init(self, generator: torch.Generator, *,
             device: Union[str, torch.device] = "cpu") -> nn.ModuleDict:
        """A random, unfolded parameter tree (the JAX ``Model.init``):
        He-normal conv weights drawn from ``generator``, BatchNorm at its
        defaults (``ops/init.py``), conv weights channels_last, on
        ``device``."""
        params = I.init_tree(FD.make_fastdepth(self.config, folded=False), generator)
        return _channels_last(params).to(device)

    def apply(self, params: nn.ModuleDict, x: torch.Tensor, *, train: bool = False,
              stats: Optional[L.StatsDict] = None) -> torch.Tensor:
        """The straight NHWC forward (``apply_fastdepth``); ``train`` and
        ``stats`` as there (train-mode BatchNorm, running statistics
        recorded into ``stats``)."""
        return FD.apply_fastdepth(params, x, self.config, train=train, stats=stats)

    def fold(self, params: nn.ModuleDict) -> nn.ModuleDict:
        """A copy with every BatchNorm folded and, where K1 covers the
        architecture, each decoder level's weights in K1's layout.  Fold
        f32 params, before any cast to bf16.  Folding a folded tree only
        derives the layouts."""
        folded = L.tree_fold(params)
        if F.supports_fused(self.config):
            F.attach_kernel_weights(folded)
        return folded


def build(cfg: ModelConfig) -> Model:
    cfg.validate()
    if cfg.encoder.startswith("resnet"):
        raise NotImplementedError(
            f"{cfg.encoder!r} models are not ported yet (ROADMAP A11: ResNet encoders)")
    if cfg.encoder != "mobilenet":
        raise ValueError(f"unknown encoder family: {cfg.encoder!r}")
    if cfg.skip is None:
        raise NotImplementedError(
            f"plain MobileNet + {cfg.decoder!r} decoder models are not ported yet "
            "(ROADMAP A11: registry decoders)")
    return Model(cfg)


def from_name(name: str) -> Model:
    """Parse 'mobilenet-nnconv5dw-skipadd-pruned' style names (reference
    README.md:39-41 model naming)."""
    parts = name.split("-")
    encoder = parts[0]
    decoder = parts[1] if len(parts) > 1 else "nnconv5dw"
    skip: Optional[str] = None
    if "skipadd" in parts:
        skip = "add"
    elif "skipconcat" in parts:
        skip = "concat"
    if encoder == "mobilenet":
        pruned = "pruned" in parts
        cfg = ModelConfig(
            encoder="mobilenet", decoder=decoder, skip=skip,
            encoder_channels=PRUNED_ENCODER_CHANNELS if pruned else FASTDEPTH_UNPRUNED.encoder_channels,
            decoder_channels=PRUNED_DECODER_CHANNELS if pruned else FASTDEPTH_UNPRUNED.decoder_channels,
        )
    else:
        cfg = ModelConfig(encoder=encoder, decoder=decoder, skip=skip)
    return build(cfg)


# The two released FastDepth variants.
def fastdepth_unpruned() -> Model:
    return build(FASTDEPTH_UNPRUNED)


def fastdepth_pruned() -> Model:
    return build(FASTDEPTH_PRUNED)
