"""The comparison that decides ``correct``.

The program's answers kept from the window are held against the plain
reference, computed in f32 with TF32 off from the same parameter tree
and the same frames, in blocks, after the program's state is freed:

- ``pred_rel_l2`` / ``answer_rel_l2``: over the sampled frames, the
  largest relative L2 distance ||answer - reference|| / ||reference||
  of one frame's depth map;
- ``<that>_over_witness``: the same over the reference's own largest
  distance when it computes in the cell's dtype (the witness), which
  takes out how far the seed's weights amplify rounding;
- ``metric_gap`` (evaluation cells): over the sampled frames and the
  ten metrics, the largest gap between the program's metric row and the
  reference's metrics (f64) of the program's own depth, which the
  reference reads only to judge the rows; relative to the reference's
  value for the seven error metrics, absolute for the three delta
  shares.

A control puts the reference itself in the program's place, computed in
the precision below the program's (:data:`CONTROLS`: below the cell's
dtype for the forward; bfloat16 for the metrics, which the program sums
in f32), and must come out not correct.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from perfbench import program
from perfbench.reference import common as C

# the precision below the one a cell computes in
CONTROLS = {"bfloat16": "fp8", "float16": "fp8", "float32": "tf32"}
WITNESSED = "_over_witness"  # a compared number's suffix: over the witness's


def reference_outputs(cfg: dict, sd, inputs: torch.Tensor, precision: str,
                      device) -> torch.Tensor:
    """The reference's NHWC f32 depth of ``inputs`` in ``precision``."""
    ref = program.reference(cfg)
    allow_tf32, conv = C.PRECISIONS[precision]
    with torch.no_grad(), C.tf32(allow_tf32):
        return C.in_blocks(lambda x: ref.forward(sd, x.to(device), cfg, conv=conv).cpu(),
                           inputs, cfg["reference_block"])


def witness(wl: dict) -> Optional[str]:
    """The precision of the witness where the cell's limits compare to it."""
    return wl["dtype"] if any(k.endswith(WITNESSED) for k in wl["limits"]) else None


def numbers(samples: dict, cfg: dict, device, control: Optional[str] = None,
            detail: Optional[dict] = None, witness: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of a run's samples; with ``control``, of the
    reference in that precision in the program's place; with
    ``witness``, also the largest gap over the reference's own in that
    precision.  ``detail``, if given, gets the frames' gaps at their
    quartiles and each metric's largest gap."""
    sd = samples["params"]
    ref = reference_outputs(cfg, sd, samples["inputs"], "float32", device)

    def answered(precision):  # the reference as the program answers: f16 answers rounded
        out = reference_outputs(cfg, sd, samples["inputs"], precision, device)
        return out.half().float() if samples["outputs"].dtype == torch.float16 else out

    def gaps(out):
        return (out - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)

    out = samples["outputs"].float().cpu() if control is None else answered(control)
    rel = gaps(out)
    result = {samples["name"]: float(rel.max())}
    if witness is not None:
        result[samples["name"] + WITNESSED] = float(rel.max() / gaps(answered(witness)).max())
    if detail is not None:
        detail["frames"] = int(rel.numel())
        detail["frame_gap_quartiles"] = [float(v) for v in rel.quantile(
            torch.tensor([0.25, 0.5, 0.75]))]
    if "depth" in samples:
        depth = samples["depth"].cpu()
        want = C.depth_metrics(out, depth)
        got = (samples["metric_rows"].double().cpu().numpy() if control is None
               else C.depth_metrics(out, depth, torch.bfloat16))
        fraction = np.isin(np.asarray(C.METRIC_FIELDS), C.FRACTION_FIELDS)[:, None]
        gap = np.abs(got - want) / np.where(fraction, 1.0, np.abs(want))
        result["metric_gap"] = float(gap.max())
        if detail is not None:
            detail["metric_gap_by_field"] = dict(zip(C.METRIC_FIELDS, gap.max(axis=1).tolist()))
    return result


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit beside it; a limit without its number
    is an error."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def correct(compared: Dict[str, dict], failed: int) -> bool:
    """Every number at or under its limit (a NaN is not), and no request
    failed."""
    return failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
