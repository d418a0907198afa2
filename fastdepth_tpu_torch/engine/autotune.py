"""Per-level kernel selection on the card — counterpart of
``fastdepth_tpu/engine/autotune.py``, the analogue of the reference's
AutoTVM tuning database (reference tvm_compile/tuning/*.log: best
per-layer kernel configs and times, SURVEY.md C12).

Each decoder level has two implementations, timed per (level, dtype) on
the attached card by :func:`tune_decoder`; :func:`load_tuning` replays a
record as the winner map ``models/fused.apply_fastdepth_mixed`` runs.
The record format is the JAX package's word for word, impl names
included, so either package reads the other's records.  In the port the
two names mean:

* ``"xla"``: the plain stage through cuDNN/ATen (dw5x5 -> ReLU -> pw1x1
  -> ReLU -> nearest x2 -> + skip or concat; a dense decoder's conv ->
  ReLU -> x2), as the JAX package's name is for its XLA path;
* ``"pallas"``: K1 (``ops/cuda/fused_decoder.py``), the port's hand-written
  kernel for the JAX package's Pallas stage, timed where JAX times Pallas
  (5x5 depthwise levels that do not concat).

Both are timed with ``engine/benchmark.time_pipelined`` (back-to-back
calls on one input set: the operands stay in the 50 MB L2, as in the JAX
package's yardstick); the kernel rows of ``PERF.md`` use
``time_graph``, L2 cold.  Records are committed under ``tuning/`` as
``<tag>.<model>.json`` (:func:`device_tag`: ``h100`` on an H100).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from fastdepth_tpu_torch.config import MOBILENET_STRIDES

Device = Union[str, torch.device]


def _stage_shapes(cfg) -> List[Dict]:
    """Decoder stage IO shapes for a FastDepth config at 224x224.

    Skip semantics follow the real forward: stages 2/3/4 combine encoder
    taps x3/x2/x1 (= enc[5]/enc[3]/enc[1] channels) after their upsample.
    For skip='add' the tap width equals the stage's cout (the add
    constraint) and channel flow is unchanged; for skip='concat' the NEXT
    stage's cin widens to cout + tap — timing the un-widened conv would
    measure a layer the model never runs."""
    enc = cfg.encoder_channels
    dec = cfg.decoder_channels
    taps = {2: enc[5], 3: enc[3], 4: enc[1]}  # x3/x2/x1 tap widths
    h = 224 // 32
    shapes = []
    cin = enc[-1]
    for i, cout in enumerate(dec, start=1):
        has_skip = cfg.skip is not None and i in (2, 3, 4)
        spec = {"stage": i, "h": h, "w": h, "cin": cin, "cout": cout,
                "skip": has_skip}
        if has_skip:
            spec["skip_mode"] = cfg.skip
            spec["tap"] = taps[i]
        shapes.append(spec)
        h *= 2
        cin = cout + (taps[i] if has_skip and cfg.skip == "concat" else 0)
    return shapes


def _encoder_op_shapes(cfg) -> List[Dict]:
    """Per-op encoder shapes at 224x224 — every conv the reference's
    AutoTVM logs cover (stem + dw/pw per block, reference
    tvm_compile/tuning/*.log tasks; strides from MOBILENET_STRIDES)."""
    enc = cfg.encoder_channels
    shapes = [{"op": "stem", "h": 224, "w": 224, "cin": cfg.in_channels,
               "cout": enc[0], "k": 3, "stride": 2}]
    h = 112
    cin = enc[0]
    for i in range(1, 14):
        s = MOBILENET_STRIDES[i - 1]
        shapes.append({"op": f"conv{i}.dw", "h": h, "w": h, "cin": cin,
                       "cout": cin, "k": 3, "stride": s})
        h //= s
        shapes.append({"op": f"conv{i}.pw", "h": h, "w": h, "cin": cin,
                       "cout": enc[i], "k": 1, "stride": 1})
        cin = enc[i]
    return shapes


def _rand(rng, shape, dtype, device, scale=1.0) -> torch.Tensor:
    """Seeded uniform values (the JAX records' ``rng.rand``) on ``device``."""
    return torch.from_numpy(rng.rand(*shape) * scale).to(device=device, dtype=dtype)


def _activation(rng, n, h, w, c, dtype, device) -> torch.Tensor:
    """A seeded NHWC ``rng.rand`` activation as the port's channels_last
    NCHW tensor."""
    from fastdepth_tpu_torch.ops.blocks import from_nhwc

    return from_nhwc(_rand(rng, (n, h, w, c), dtype, device))


def _time_ms(fn, x, warmup: int, calls: int, device: Device) -> float:
    from fastdepth_tpu_torch.engine.benchmark import time_pipelined

    with torch.inference_mode():
        stats = time_pipelined(fn, (x,), warmup=warmup, calls=calls, device=device)
    return round(stats["mean_s"] * 1e3, 4)


def tune_encoder(
    cfg,
    *,
    batch: int = 32,
    dtypes=("bfloat16", "float32"),
    warmup: int = 2,
    calls: int = 20,
    device: Device = "cuda",
) -> List[Dict]:
    """Per-op cuDNN timings for every encoder conv (conv + bias + ReLU6).
    Informational, as in the JAX package: cuDNN is the port's only
    encoder implementation, so nothing at run time chooses among
    encoder impls."""
    from fastdepth_tpu_torch.ops import blocks as B

    rng = np.random.RandomState(0)
    records = []
    for spec in _encoder_op_shapes(cfg):
        h, w, cin, cout, k, s = (spec[x] for x in ("h", "w", "cin", "cout", "k", "stride"))
        depthwise = spec["op"].endswith(".dw")
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            x = _activation(rng, batch, h, w, cin, dtype, device)
            wgt = _rand(rng, (cin, 1, k, k) if depthwise else (cout, cin, k, k), dtype,
                        device, 0.1)
            b = _rand(rng, (cout,), dtype, device, 0.1)
            conv = B.depthwise_conv2d if depthwise else B.conv2d

            def fn(x, wgt=wgt, b=b, s=s, conv=conv):
                return B.relu6(conv(x, wgt, stride=s, bias=b))

            rec = dict(spec, dtype=dtype_name, batch=batch)
            try:
                rec["xla_ms"] = _time_ms(fn, x, warmup, calls, device)
            except Exception as e:  # a failed op is a record entry, as in the JAX package
                rec["xla_ms"] = None
                rec["xla_error"] = f"{type(e).__name__}"
            rec["winner"] = "xla" if rec["xla_ms"] is not None else None
            records.append(rec)
    return records


def _folded_stage(dw_w, dw_b, pw_w, pw_b) -> torch.nn.ModuleDict:
    """One folded decoder level, as ``Model.fold`` leaves it: the ``dw``
    and ``pw`` leaves and K1's weight layouts (``k1_dw``, ``k1_pw``)."""
    from fastdepth_tpu_torch.models.layers import ConvBN
    from fastdepth_tpu_torch.ops.cuda.fused_decoder import kernel_weights

    p = torch.nn.ModuleDict({"dw": ConvBN(dw_w, b=dw_b), "pw": ConvBN(pw_w, b=pw_b)})
    k_dw, k_pw = kernel_weights(dw_w, pw_w)
    p.register_buffer("k1_dw", k_dw, persistent=False)
    p.register_buffer("k1_pw", k_pw, persistent=False)
    return p


def _mixed_stage(name: str, i: int, p, skip):
    """``apply_fastdepth_mixed``'s stage for the impl ``name`` at level
    ``i``, as a function of the level's input."""
    from fastdepth_tpu_torch.models import fused as F

    stage = F.MIXED_STAGES[name]
    return lambda x: stage(i, x, p, skip, None)


def tune_decoder(
    cfg,
    *,
    batch: int = 4,
    dtypes=("bfloat16", "float32"),
    warmup: int = 2,
    calls: int = 20,
    out_path: Optional[str] = None,
    with_pallas: bool = True,
    device: Device = "cuda",
) -> Dict:
    """Times the plain stage ('xla') against K1 ('pallas') per decoder
    level and dtype on ``device``; returns (and optionally writes) the
    tuning record.  At the levels ``apply_fastdepth_mixed`` can run (5x5
    depthwise, no concat) both are its own stage functions
    (``models/fused.MIXED_STAGES``) on a folded level; the other levels
    time a local plain stage.  Dense (non-depthwise) decoders have no K1 stage:
    'xla'-only records, like the reference's dense logs.  On the CPU,
    'pallas' times K1's plain version (a CPU time, for the record's
    shape only)."""
    from fastdepth_tpu_torch.ops import blocks as B

    k = cfg.decoder_kernel
    depthwise = cfg.decoder_depthwise
    rng = np.random.RandomState(0)
    records = []
    for spec in _stage_shapes(cfg):
        h, w, cin, cout = spec["h"], spec["w"], spec["cin"], spec["cout"]
        concat = spec.get("skip_mode") == "concat"
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            x = _activation(rng, batch, h, w, cin, dtype, device)
            # the combined tensor is an add of a cout-wide tap, or a
            # concat of a tap-wide one
            skip = (_activation(rng, batch, 2 * h, 2 * w, spec["tap"], dtype, device)
                    if spec["skip"] else None)

            def combine(y, skip=skip, concat=concat):
                if skip is None:
                    return y
                return torch.cat([y, skip], dim=1) if concat else y + skip

            if depthwise:
                dw_w = _rand(rng, (cin, 1, k, k), dtype, device, 0.1)
                dw_b = _rand(rng, (cin,), dtype, device, 0.1)
                pw_w = _rand(rng, (cout, cin, 1, 1), dtype, device, 0.1)
                pw_b = _rand(rng, (cout,), dtype, device, 0.1)
                if k == 5 and not concat:
                    # the levels apply_fastdepth_mixed runs: time the very
                    # stages it dispatches to, K1 only where JAX times Pallas
                    stage = _folded_stage(dw_w, dw_b, pw_w, pw_b)
                    impls = [(name, _mixed_stage(name, spec["stage"], stage, skip))
                             for name in (("xla", "pallas") if with_pallas else ("xla",))]
                else:
                    def xla_path(x, combine=combine, dw_w=dw_w, dw_b=dw_b, pw_w=pw_w,
                                 pw_b=pw_b):
                        y = B.relu(B.depthwise_conv2d(x, dw_w, bias=dw_b))
                        y = B.relu(B.conv2d(y, pw_w, bias=pw_b))
                        return combine(B.upsample_nearest2x(y))

                    impls = [("xla", xla_path)]
            else:
                c_w = _rand(rng, (cout, cin, k, k), dtype, device, 0.1)
                c_b = _rand(rng, (cout,), dtype, device, 0.1)

                def xla_path(x, combine=combine, c_w=c_w, c_b=c_b):
                    y = B.relu(B.conv2d(x, c_w, bias=c_b))
                    return combine(B.upsample_nearest2x(y))

                impls = [("xla", xla_path)]

            rec = dict(spec, dtype=dtype_name, batch=batch)
            for name, fn in impls:
                try:
                    rec[f"{name}_ms"] = _time_ms(fn, x, warmup, calls, device)
                except Exception as e:  # a failed impl is a record entry, as in JAX
                    rec[f"{name}_ms"] = None
                    rec[f"{name}_error"] = f"{type(e).__name__}"
            times = {k2: rec[f"{k2}_ms"] for k2 in ("xla", "pallas")
                     if rec.get(f"{k2}_ms") is not None}
            rec["winner"] = min(times, key=times.get) if times else None
            records.append(rec)

    result = {
        "config": {"encoder_channels": list(cfg.encoder_channels),
                   "decoder_channels": list(cfg.decoder_channels),
                   "decoder": cfg.decoder, "skip": cfg.skip},
        "device": _device_kind(device),
        "records": records,
    }
    if out_path:
        _write(result, out_path)
    return result


def tune_model(
    cfg,
    *,
    batch_enc: int = 32,
    batch_dec: int = 4,
    dtypes=("bfloat16", "float32"),
    warmup: int = 2,
    calls: int = 20,
    out_path: Optional[str] = None,
    with_pallas: bool = True,
    device: Device = "cuda",
) -> Dict:
    """Full tuning record: every encoder conv op + every decoder stage —
    the breadth of one reference AutoTVM log (all conv tasks of one
    model, tvm_compile/tuning/*.log)."""
    dec = tune_decoder(cfg, batch=batch_dec, dtypes=dtypes, warmup=warmup,
                       calls=calls, with_pallas=with_pallas, device=device)
    enc = tune_encoder(cfg, batch=batch_enc, dtypes=dtypes, warmup=warmup,
                       calls=calls, device=device)
    result = {
        "config": dec["config"],
        "device": dec["device"],
        # the encoder half is informational: cuDNN is the only encoder
        # implementation, so nothing at run time selects among encoder
        # impls; load_tuning / --impl mixed read 'records' only
        "encoder_records_note": (
            "informational: cuDNN is the only encoder implementation "
            "(there is no encoder kernel of the port), so no runtime "
            "selection reads these; they document measured per-op "
            "encoder costs for breadth parity with the reference's "
            "AutoTVM logs. Runtime consumers (load_tuning -> --impl "
            "mixed) read 'records' only."),
        "encoder_records": enc,
        "records": dec["records"],
    }
    if out_path:
        _write(result, out_path)
    return result


def _write(result: Dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)


def _device_kind(device: Device = "cuda") -> str:
    """The name of the device a record was measured on: the card's
    (``torch.cuda.get_device_name``), or ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_tag(kind: str) -> str:
    """A record file's device tag from a device name: the card's model
    (``NVIDIA H100 80GB HBM3`` -> ``h100``), else the name without spaces,
    lower case (the JAX package's rule: ``TPU v5 lite`` -> ``tpuv5lite``)."""
    m = re.search(r"\b([A-Z]+\d+)\b", kind)
    return (m.group(1) if m else kind.replace(" ", "")).lower()


def _dtype_name(dtype) -> Optional[str]:
    """'bfloat16' / 'float32' from a name, a torch dtype or a numpy dtype."""
    if dtype is None or isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def load_tuning(path: str, dtype=None) -> Dict[int, str]:
    """Tuning record -> {stage: 'xla' | 'pallas'} winner map.

    ``dtype`` ('bfloat16' / 'float32' / a torch or numpy dtype) selects
    the winners measured at that compute dtype — the records differ per
    dtype.  Stages with no record at the requested dtype fall back to
    whatever dtype was measured.  ``None`` keeps the historical bf16
    preference."""
    pref = _dtype_name(dtype) or "bfloat16"
    with open(path) as f:
        data = json.load(f)
    winners: Dict[int, str] = {}
    for rec in data["records"]:
        if rec.get("winner"):
            # matching-dtype records override; others only fill gaps
            if rec["stage"] not in winners or rec["dtype"] == pref:
                winners[rec["stage"]] = rec["winner"]
    return winners
