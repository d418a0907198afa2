"""Readings for a cell's limits: the compared numbers of the program
over many seeds, and of the control (the reference in the precision
below the cell's, in the program's place) over some of them, at the
cell's own size and load, in one process.

    python -m perfbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 --control 3

Prints one JSON line a seed (``program``, and ``control`` for the first
``--control`` seeds; for a bf16 cell also ``witness``, the reference
computed in bf16, which a sound bf16 program should read alike), then
the largest program reading and the smallest control reading of each
number.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json

from perfbench import check, harness
from perfbench.context import Ctx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3, help="seeds the control runs on")
    args = p.parse_args(argv)
    import torch

    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    entry = harness.module("entries", wl["entry"])
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = entry.run(Ctx(cell=args.workload, workload=wl, config=cfg, seed=seed,
                            seconds=args.seconds, trace=False))
        torch.cuda.empty_cache()
        row = {"seed": seed, "failed": out.failed, "detail": {}}
        row["program"] = check.numbers(out.samples, cfg, "cuda", detail=row["detail"],
                                       witness=check.witness(wl))
        if i < args.control:
            row["control_detail"] = {}
            row["control"] = check.numbers(out.samples, cfg, "cuda",
                                           control=check.CONTROLS[wl["dtype"]],
                                           detail=row["control_detail"],
                                           witness=check.witness(wl))
        if wl["dtype"] == "bfloat16":
            row["witness"] = check.numbers(out.samples, cfg, "cuda", control="bfloat16")
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in row.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "limits": wl["limits"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
