"""The program under test, as the benchmark hands it its inputs: the
port's model for a configuration file, with the seeded parameter tree
the benchmark drew loaded into it.  The entries import the port through
here and their own drivers; nothing else of the benchmark imports it.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench import harness
from perfbench.reference import common


def reference(cfg: dict):
    """The configuration's plain reference module."""
    return harness.module("reference", cfg["family"])


def draw_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's unfolded parameter tree drawn from ``seed`` on
    ``device``, f32: what the program and the reference are both given."""
    return common.draw(reference(cfg).schema(cfg), seed, device)


def model(cfg: dict):
    """The port's ``Model`` of the configuration: its published widths."""
    from fastdepth_tpu_torch.config import ModelConfig
    from fastdepth_tpu_torch.models.registry import build

    port = dict(cfg["port_model"])
    if port["encoder"] == "mobilenet":
        port["encoder_channels"] = tuple(cfg["encoder_channels"])
    port["decoder_channels"] = tuple(cfg["decoder_channels"])
    return build(ModelConfig(**port, output_size=tuple(cfg["image_size"])))


def load(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """(Model, the port's parameter tree holding ``sd``) on ``device``."""
    m = model(cfg)
    return m, m.load(sd, device=device)
