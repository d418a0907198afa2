"""Model registry: config -> Model, and name-string parsing — counterpart
of ``fastdepth_tpu/models/registry.py``.

Every family the JAX registry builds: the MobileNet skip family
(MobileNetSkipAdd/Concat, pruned or not; ``models/fastdepth.py``), plain
MobileNet + any registry decoder (``models/decoders.py``), and ResNet-18
to -152, plain with a registry decoder or with add/concat skips
(``models/resnet.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

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
from fastdepth_tpu_torch.models import resnet as RN
from fastdepth_tpu_torch.ops import init as I


def _channels_last(params: nn.ModuleDict) -> nn.ModuleDict:
    for m in params.modules():
        if isinstance(m, L.ConvBN):
            m.w.data = m.w.data.contiguous(memory_format=torch.channels_last)
    return params


def _family(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """(make(cfg, folded=...), apply(params, x, cfg, train=..., stats=...))
    of the config's model family."""
    if cfg.encoder == "mobilenet":
        if cfg.skip is None:
            return FD.make_mobilenet_decoder, FD.apply_mobilenet_decoder
        return FD.make_fastdepth, FD.apply_fastdepth
    if cfg.encoder.startswith("resnet"):
        return RN.make_resnet_depth, RN.apply_resnet_depth
    raise ValueError(f"unknown encoder family: {cfg.encoder!r}")


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
        params = _family(self.config)[0](self.config, folded=folded)
        params.load_state_dict(state_dict, strict=True)
        return _channels_last(params).to(device)

    def init(self, generator: torch.Generator, *,
             device: Union[str, torch.device] = "cpu") -> nn.ModuleDict:
        """A random, unfolded parameter tree (the JAX ``Model.init``):
        He-normal conv weights drawn from ``generator``, BatchNorm at its
        defaults (``ops/init.py``), conv weights channels_last, on
        ``device``."""
        params = I.init_tree(_family(self.config)[0](self.config, folded=False), generator)
        return _channels_last(params).to(device)

    def apply(self, params: nn.ModuleDict, x: torch.Tensor, *, train: bool = False,
              stats: Optional[L.StatsDict] = None, space=None) -> torch.Tensor:
        """The straight NHWC forward of the config's family; ``train`` and
        ``stats`` as in ``layers.apply_conv_bn`` (train-mode BatchNorm,
        running statistics recorded into ``stats`` under the JAX
        package's paths).  ``space`` (a ``parallel.spatial.Partition``):
        height-sharded, ``x`` and the result this rank's rows (every
        family; inference only)."""
        fn = _family(self.config)[1]
        if space is None:
            return fn(params, x, self.config, train=train, stats=stats)
        return fn(params, x, self.config, train=train, stats=stats, space=space)

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
    _family(cfg)
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
