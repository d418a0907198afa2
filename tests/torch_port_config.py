"""The tests' boundary between the two packages' ModelConfig classes.

The port keeps its own copy of ``fastdepth_tpu/config.py``: the two
``ModelConfig`` classes have equal fields but are different classes, and
the port is never handed the JAX package's.  A test that builds one
configuration for both packages converts it here."""

import dataclasses

from fastdepth_tpu import config as jax_config
from fastdepth_tpu_torch import config as port_config


def to_port(cfg) -> port_config.ModelConfig:
    return port_config.ModelConfig(**dataclasses.asdict(cfg))


def to_jax(cfg) -> jax_config.ModelConfig:
    return jax_config.ModelConfig(**dataclasses.asdict(cfg))
