"""Roofline bounds for the FastDepth forward on the H100 — counterpart of
``fastdepth_tpu/engine/roofline.py``.

The formulas are the JAX module's, copied here and held equal to it by
tests/test_torch_roofline.py and tests/test_torch_config.py:
:func:`measured_stage_bounds` and :func:`measured_composite_us` are that
module's functions, and :func:`layer_bounds` its per-layer MAC and
conv-boundary element counts (every conv reads a materialized input and
writes a materialized output; a decoder stage adds its upsampled write
and skip read).

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
import json
import os
from typing import List, Optional, Tuple

from fastdepth_tpu_torch.config import MOBILENET_STRIDES

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CEILINGS_PATH = os.path.join(_REPO, "docs", "probe_h100_hbm.json")


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
    the JAX module's rows with the depthwise work unpadded.  ``macs`` is
    the true MAC count; ``hbm_elems`` is in elements — multiply by the
    dtype's byte width."""
    enc = cfg.encoder_channels
    dec = cfg.decoder_channels
    rows: List[Tuple[str, int, int, int, int]] = []

    hw = image_size
    h = hw // 2  # after the stride-2 stem
    stem_macs = h * h * enc[0] * 9 * 3
    rows.append(("enc.conv0", stem_macs, hw * hw * 3 + h * h * enc[0], stem_macs, 0))
    cin = enc[0]
    for i in range(1, 14):
        ho = h // MOBILENET_STRIDES[i - 1]
        cout = enc[i]
        dw_macs = ho * ho * cin * 9
        pw_macs = ho * ho * cin * cout
        rows.append((f"enc.conv{i}", dw_macs + pw_macs,
                     h * h * cin + ho * ho * cin * 2 + ho * ho * cout, pw_macs, dw_macs))
        h, cin = ho, cout

    skips = {2, 3, 4} if cfg.skip else set()
    # encoder tap widths combined after stages 2/3/4; for skip='add' the
    # tap is cout, for 'concat' it is read at its own width and the NEXT
    # stage's cin widens to cout + tap
    taps = {2: enc[5], 3: enc[3], 4: enc[1]}
    concat = cfg.skip == "concat"
    k2 = cfg.decoder_kernel * cfg.decoder_kernel
    for i, cout in enumerate(dec, start=1):
        dw_macs = h * h * cin * k2
        pw_macs = h * h * cin * cout
        tap = taps[i] if i in skips else 0
        rows.append((f"dec.stage{i}", dw_macs + pw_macs,
                     h * h * cin * 3 + h * h * cout + (2 * h) ** 2 * (cout + tap),
                     pw_macs, dw_macs))
        h, cin = 2 * h, cout + (tap if concat else 0)

    head_macs = h * h * cin
    rows.append(("dec.head", head_macs, h * h * cin + h * h, head_macs, 0))
    return rows


def measured_stage_bounds(cfg, probe: dict, image_size: int = 224):
    """The JAX module's measured-ceiling bounds for the dw decoder stages
    3-5 from a TPU probe payload (``docs/probe_r3_hbm.json``): the measured
    dw5x5 chain time per frame at b128, plus the pointwise bytes at the
    measured pw-conv rate, plus the upsample (+skip-add) bytes at the
    measured add-pattern (skip stages) or elementwise rate.  Returns
    {stage_index: (total_us, dw_us, pw_us, ups_us)} per frame."""
    rows = {r["name"]: r for r in probe["rows"]}
    batch = 128  # the probes ran b128
    dw_us = {
        3: rows["dec3 dw5x5 256ch@28^2"]["per_pass_us"] / batch,
        4: rows["dec4 dw5x5 120ch@56^2"]["per_pass_us"] / batch,
        5: rows["dec5 dw5x5 56ch@112^2"]["per_pass_us"] / batch,
    }
    pw_bps = rows["pw 56->56 @112^2"]["GBs"] * 1e9
    add_bps = rows["add+mul dec4_out (5 moves)"]["GBs"] * 1e9
    mul_bps = rows["mul dec5_out (128,224,224,16)"]["GBs"] * 1e9

    enc, dec = cfg.encoder_channels, cfg.decoder_channels
    skips = {2, 3, 4} if cfg.skip else set()
    taps = {2: enc[5], 3: enc[3], 4: enc[1]}  # == cout for skip='add'
    concat = cfg.skip == "concat"
    h = image_size // 32  # spatial size entering the first decoder stage
    cin = enc[13]
    out = {}
    for i, cout in enumerate(dec, start=1):
        tap = taps[i] if i in skips else 0
        if i in dw_us:
            pw_b = (h * h * cin + h * h * cout) * 2
            ups_b = (h * h * cout + (2 * h) ** 2 * (cout + tap)) * 2
            pw_t = pw_b / pw_bps * 1e6
            ups_t = ups_b / (add_bps if i in skips else mul_bps) * 1e6
            out[i] = (dw_us[i] + pw_t + ups_t, dw_us[i], pw_t, ups_t)
        h, cin = 2 * h, cout + (tap if concat else 0)
    return out


def measured_composite_us(cfg, probe: dict, image_size: int = 224) -> float:
    """The JAX module's per-frame composite bound: decoder stages with a
    measured dw chain use :func:`measured_stage_bounds`; every other row's
    conv-boundary bytes (bf16) are priced at the measured 64 MB elementwise
    rate; the head row at a quarter of its bytes (head-commuted forward)."""
    meas = measured_stage_bounds(cfg, probe, image_size)
    elt_bps = {r["name"]: r for r in probe["rows"]}["flat mul bf16 64MB"]["GBs"] * 1e9
    total = 0.0
    for key, _macs, hbm_e, _mxu, _dw in layer_bounds(cfg, image_size):
        if key.startswith("dec.stage") and int(key[-1]) in meas:
            total += meas[int(key[-1])][0]
        elif key == "dec.head":
            total += hbm_e / 4 * 2 / elt_bps * 1e6
        else:
            total += hbm_e * 2 / elt_bps * 1e6
    return total


def data_sheet_ceilings(probe: dict) -> Ceilings:
    """bf16 ceilings at the published rates the calibration JSON records
    (its ``data_sheet``): device memory, the tensor cores' bf16 rate for
    the pointwise work and the CUDA cores' f32 rate for the depthwise
    work, a MAC two FLOPs."""
    ds = probe["data_sheet"]
    return Ceilings(hbm_bps=ds["hbm_GBs"] * 1e9,
                    pointwise_macs=ds["bf16_tensor_tflops"] * 1e12 / 2,
                    depthwise_macs=ds["f32_tflops"] * 1e12 / 2, card=ds["source"])


def spec_composite_us(cfg, probe: dict, image_size: int = 224) -> float:
    """The per-frame spec-peak aggregate that the root ``bench.py`` divides
    by for ``x_roofline_spec`` (its 37.7 us/frame is the TPU's:
    ``docs/roofline.md``): every :func:`layer_bounds` row's bf16 bound at
    :func:`data_sheet_ceilings`, the head row with a quarter of its bytes
    (the head-commuted forward writes the head's output before the last
    upsample)."""
    ceil = data_sheet_ceilings(probe)
    return sum(bound_seconds(hbm_e / 4 if key == "dec.head" else hbm_e, mxu, dw, 2, ceil)
               for key, _macs, hbm_e, mxu, dw in layer_bounds(cfg, image_size)) * 1e6


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
