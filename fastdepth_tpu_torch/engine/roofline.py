"""Roofline bounds for the FastDepth forward on the H100 — counterpart of
``fastdepth_tpu/engine/roofline.py``.

The formulas are the JAX module's, shared so that they cannot drift:
:func:`measured_stage_bounds` and :func:`measured_composite_us` are that
module's functions, and :func:`layer_bounds` takes its per-layer MAC and
conv-boundary element counts (every conv reads a materialized input and
writes a materialized output; a decoder stage adds its upsampled write
and skip read).  The module is loaded from its file: it holds no JAX, but
``fastdepth_tpu.engine``'s ``__init__`` imports the JAX evaluator.

What differs on the card:

* the ceilings are the H100's, measured by ``engine/calibrate.py`` into
  ``docs/probe_h100_hbm.json`` (:func:`load_ceilings`): device memory is
  the best 256 MB copy or multiply rate, the pointwise (and dense) work
  runs at the measured matmul rate of the dtype (bf16 on the tensor cores;
  f32 with TF32 off).  A rate that no probe measures, the CUDA cores' f32
  FMA rate that bounds the depthwise work, is the H100 SXM data sheet's,
  and the JSON names it so;
* the depthwise work is ``macs - mxu_macs`` MACs, unpadded: the 128-lane
  padding of the JAX module is a TPU rule.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List, Optional, Tuple

import fastdepth_tpu

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CEILINGS_PATH = os.path.join(_REPO, "docs", "probe_h100_hbm.json")


def _formulas():
    path = os.path.join(os.path.dirname(fastdepth_tpu.__file__), "engine", "roofline.py")
    spec = importlib.util.spec_from_file_location("fastdepth_tpu_roofline_formulas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_F = _formulas()
measured_stage_bounds = _F.measured_stage_bounds
measured_composite_us = _F.measured_composite_us


@dataclasses.dataclass(frozen=True)
class Ceilings:
    """Rates for one dtype: bytes/s of device memory, MAC/s of the
    pointwise/dense work, MAC/s of the depthwise work, and the card they
    were measured on (``nvidia-smi``'s name and power limit)."""

    hbm_bps: float
    pointwise_macs: float
    depthwise_macs: float
    card: str = "unmeasured"


def load_ceilings(dtype_bytes: int, path: Optional[str] = None) -> Ceilings:
    """The H100 ceilings for bf16 (2 bytes) or f32 (4) from the
    calibration JSON (default ``docs/probe_h100_hbm.json``)."""
    with open(path or CEILINGS_PATH) as f:
        probe = json.load(f)
    c = probe["ceilings"]
    key = {2: "bf16", 4: "f32"}[dtype_bytes]
    return Ceilings(hbm_bps=c["hbm_bps"], pointwise_macs=c["pointwise_macs"][key],
                    depthwise_macs=c["depthwise_macs"],
                    card=probe["card"]["nvidia_smi"])


def layer_bounds(cfg, image_size: int = 224) -> List[Tuple[str, int, int, int, int]]:
    """Per-frame ``(key, macs, hbm_elems, mxu_macs, depthwise_macs)`` per
    attribution point (stem, 13 encoder blocks, 5 decoder stages, head):
    the JAX module's rows with the depthwise work unpadded."""
    return [(key, macs, hbm_e, mxu, macs - mxu)
            for key, macs, hbm_e, mxu, _vpu_padded in _F.layer_bounds(cfg, image_size)]


def bound_components_us(hbm_elems: int, mxu_macs: int, dw_macs: int, dtype_bytes: int,
                        ceilings: Ceilings, batch: int = 1) -> Tuple[float, float, float]:
    """(device memory, pointwise, depthwise) microseconds for a batch."""
    return (batch * hbm_elems * dtype_bytes / ceilings.hbm_bps * 1e6,
            batch * mxu_macs / ceilings.pointwise_macs * 1e6,
            batch * dw_macs / ceilings.depthwise_macs * 1e6)


def bound_seconds(hbm_elems: int, mxu_macs: int, dw_macs: int, dtype_bytes: int,
                  ceilings: Ceilings, batch: int = 1) -> float:
    """The least time for a batch: the largest of the three terms."""
    return max(bound_components_us(hbm_elems, mxu_macs, dw_macs, dtype_bytes, ceilings,
                                   batch)) / 1e6
