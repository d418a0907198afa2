"""Model / data / run configuration — the port's copy of
``fastdepth_tpu/config.py`` (the same constants and classes, field for
field; tests/test_torch_config.py holds the two equal).

The reference selects architectures with strings parsed at runtime
(``choose_decoder``, reference models.py:335-360) and hides the pruned
architecture inside a pickled module (SURVEY.md §2).  Here every
architecture is an explicit, serializable config carrying **per-layer
channel lists**, so the unpruned and NetAdapt-pruned FastDepth models are
the same class with different configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# MobileNetV1 encoder block strides are topology, not width — NetAdapt
# pruning only changed channel counts (SURVEY.md §2 "Pruned model
# architecture"; reference imagenet/mobilenet.py:40-54).
MOBILENET_STRIDES: Tuple[int, ...] = (1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1)

# (stem_out, per-block out channels) — unpruned 1.0x MobileNetV1
# (reference imagenet/mobilenet.py:40-54).
MOBILENET_V1_CHANNELS: Tuple[int, ...] = (
    32,  # stem conv 3x3 s2
    64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024,
)

# NetAdapt-pruned FastDepth channels, recovered from the AutoTVM tuning log
# shapes (reference tvm_compile/tuning/
# tx2-gpu.mobilenet-nnconv5dw-skipadd-pruned.trials=2000.stop=600.log;
# reconstruction documented in SURVEY.md §2).
PRUNED_ENCODER_CHANNELS: Tuple[int, ...] = (
    16,  # stem
    56, 88, 120, 144, 256, 408, 376, 272, 288, 296, 328, 480, 512,
)

# Decoder stage output channels (5 stages + the final 1-channel pointwise).
# Unpruned: reference models.py:683-698.  Pruned: tuning log L0-L10.
UNPRUNED_DECODER_CHANNELS: Tuple[int, ...] = (512, 256, 128, 64, 32)
PRUNED_DECODER_CHANNELS: Tuple[int, ...] = (200, 256, 120, 56, 16)

# Decoder family names, mirroring the reference registry
# (reference models.py:135-143).
DECODER_NAMES: Tuple[str, ...] = tuple(
    [f"deconv{k}{dw}" for k in (3, 5, 7, 9) for dw in ("", "dw")]
    + ["upconv", "upproj"]
    + [
        f"{kind}{k}{dw}"
        for k in (3, 5, 7, 9)
        for dw in ("", "dw")
        for kind in ("nnconv", "blconv", "shuffle")
    ]
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description for every model family in the zoo.

    ``encoder``:  'mobilenet' | 'resnet18' | 'resnet34' | 'resnet50'. . .
    ``decoder``:  a name from :data:`DECODER_NAMES`, or 'nnconv5dw' etc.
    ``skip``:     None | 'add' | 'concat'   (reference MobileNetSkipAdd /
                  MobileNetSkipConcat / ResNetSkipAdd / ResNetSkipConcat).
    """

    encoder: str = "mobilenet"
    decoder: str = "nnconv5dw"
    skip: Optional[str] = "add"
    encoder_channels: Tuple[int, ...] = MOBILENET_V1_CHANNELS
    decoder_channels: Tuple[int, ...] = UNPRUNED_DECODER_CHANNELS
    in_channels: int = 3
    output_size: Tuple[int, int] = (224, 224)
    # ReLU6 in the encoder (reference imagenet/mobilenet.py:16-20),
    # plain ReLU in decoders (reference models.py:52-75).
    encoder_relu6: bool = True
    # Beyond-reference extension: enable skip decoders on Bottleneck
    # ResNets (50/101/152).  The reference's ResNetSkipAdd/Concat only
    # ever worked on BasicBlock depths (models.py:462-652 hard-code the
    # 64/128/256/512 tap widths); with this flag, additive skips gain
    # 1x1+BN tap projections and concat skips compute decoder input
    # widths from the actual tap channels.  Off by default so the zoo
    # mirrors the reference's constraint exactly.
    bottleneck_skips: bool = False

    @property
    def decoder_kernel(self) -> int:
        for ch in self.decoder:
            if ch.isdigit():
                return int(ch)
        return 5

    @property
    def decoder_depthwise(self) -> bool:
        return "dw" in self.decoder

    def validate(self) -> "ModelConfig":
        if self.skip not in (None, "add", "concat"):
            raise ValueError(f"invalid skip mode: {self.skip!r}")
        if self.skip is not None and not self.decoder.startswith("nnconv"):
            # The reference's skip models hard-code the NNConv decoder
            # (models.py:683-697) — accepting other decoder names here
            # would silently run nnconv semantics under a wrong label.
            raise ValueError(
                "skip models implement the NNConv decoder family only "
                f"(reference models.py:683-697); got decoder={self.decoder!r}"
            )
        if self.encoder == "mobilenet":
            if len(self.encoder_channels) != 14:
                raise ValueError(
                    "mobilenet encoder needs stem + 13 block channels, got "
                    f"{len(self.encoder_channels)}"
                )
        if self.bottleneck_skips and not (
            self.skip is not None
            and self.encoder in ("resnet50", "resnet101", "resnet152")
        ):
            raise ValueError(
                "bottleneck_skips only applies to resnet50/101/152 with "
                f"skip='add'/'concat'; got encoder={self.encoder!r}, "
                f"skip={self.skip!r}")
        if self.skip is not None and self.encoder in (
            "resnet50", "resnet101", "resnet152"
        ) and not self.bottleneck_skips:
            # Bottleneck tap widths (256/512/1024/2048) don't match the
            # skip decoder's channel plan; the reference's ResNetSkipAdd/
            # Concat have the same latent constraint (they were only ever
            # built on BasicBlock depths). Fail here instead of with a
            # broadcast error inside jit tracing; opt in to the projected
            # extension with bottleneck_skips=True.
            raise ValueError(
                f"skip decoders support BasicBlock ResNets (18/34) only; "
                f"got {self.encoder!r} (Bottleneck tap widths don't match; "
                f"set bottleneck_skips=True for the projected extension)")
        if self.skip == "add" and self.encoder == "mobilenet":
            # Additive skips constrain decoder widths to encoder tap widths
            # (reference models.py:720-729; preserved by pruning, SURVEY.md §2).
            taps = (
                self.encoder_channels[5],   # x3: conv5 out @28^2, added after stage 2
                self.encoder_channels[3],   # x2: conv3 out @56^2, added after stage 3
                self.encoder_channels[1],   # x1: conv1 out @112^2, added after stage 4
            )
            want = (self.decoder_channels[1], self.decoder_channels[2], self.decoder_channels[3])
            if taps != want:
                raise ValueError(
                    f"skip-add requires decoder widths {want} to equal encoder "
                    f"tap widths {taps}"
                )
        return self


def config_from_dict(d: dict) -> "ModelConfig":
    """ModelConfig from a plain dict (checkpoint meta, ``--arch-json``
    files): list-valued fields become the tuples the frozen dataclass
    expects.  Unknown keys raise via the constructor — a typo'd field
    must not silently vanish."""
    d = dict(d)
    for key in ("encoder_channels", "decoder_channels", "output_size"):
        if key in d and d[key] is not None:
            d[key] = tuple(d[key])
    return ModelConfig(**d)


def config_from_json(path: str) -> "ModelConfig":
    """Validated ModelConfig from a JSON file — the CLI surface for
    explicit per-layer channel lists (how pruned architectures are
    specified; SURVEY.md §2 'per-layer channel lists, not a width
    multiplier')."""
    import json

    with open(path) as f:
        return config_from_dict(json.load(f)).validate()


# Canonical zoo configs.
FASTDEPTH_UNPRUNED = ModelConfig().validate()
FASTDEPTH_PRUNED = ModelConfig(
    encoder_channels=PRUNED_ENCODER_CHANNELS,
    decoder_channels=PRUNED_DECODER_CHANNELS,
).validate()


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """NYU Depth v2 pipeline settings (reference dataloaders/nyu.py)."""

    root: str = "../data/nyudepthv2"
    split: str = "val"
    modality: str = "rgb"
    raw_size: Tuple[int, int] = (480, 640)      # nyu.py:5
    output_size: Tuple[int, int] = (224, 224)   # nyu.py:11
    crop_size: Tuple[int, int] = (228, 304)     # nyu.py:37,52
    first_resize: float = 250.0 / 480.0          # nyu.py:34,51
    batch_size: int = 1
    num_workers: int = 8
    prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters.

    The public reference release is eval-only (reference main.py:45-60) but
    its CSV fieldnames / transforms define the training semantics
    (SURVEY.md header note); defaults follow the FastDepth paper recipe.
    """

    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    epochs: int = 20
    batch_size: int = 8
    lr_decay_step: int = 5
    lr_decay_gamma: float = 0.2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for data-parallel eval/training."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None = all visible devices

    def axis_names(self) -> Sequence[str]:
        return (self.data_axis,)
