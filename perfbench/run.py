"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program.  It draws the
cell's parameters and inputs from ``--seed``, sets the program up and
warms up the cell's shapes (``setup_s``: from the process's start to
the first measured request), measures for ``--seconds``, and with
``--trace 1`` then profiles traced windows of the same load
(``perfbench/trace.py``).  It frees
the program's state, holds the answers kept from the window against the
plain reference (``perfbench/check.py``), and prints, last on standard
error, each compared number beside its limit and, last on standard
output, one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and the
compared numbers last.  It exits non-zero, printing no line, without the
card the cell needs, or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

from perfbench.context import process_age  # noqa: F401  (its clock starts first)

FORBIDDEN = ("jax", "jaxlib", "flax", "fastdepth_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(cell: str, seed: int, seconds: float, trace: bool, *, root=None,
            device: str = "cuda", check_device: bool = True) -> dict:
    """One run of ``cell``: the result line's object."""
    import torch

    from perfbench import check, harness

    root = root or harness.ROOT
    entry = harness.cell_entry(cell, root)
    wl = harness.workload(cell, root)
    cfg = harness.config(wl["config"], root)
    if check_device and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= entry["chips"]):
        raise SystemExit(f"{cell} needs {entry['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    wanted = harness.metrics_of(cell, root)
    readers = {m["name"]: harness.module("metrics", m["name"], root)
               for m in wanted["per_layer"]} if trace else {}
    from perfbench.context import Ctx

    ctx = Ctx(cell=cell, workload=wl, config=cfg, seed=seed, seconds=seconds, trace=trace,
              device=device,
              python_trace=any(getattr(r, "PYTHON_CALLS", False) for r in readers.values()))
    out = harness.module("entries", wl["entry"], root).run(ctx)
    if device == "cuda":
        torch.cuda.empty_cache()
    values = check.numbers(out.samples, cfg, device, witness=check.witness(wl))
    if "unanswered" in wl["limits"]:
        values["unanswered"] = out.failed
    compared = check.judge(values, wl["limits"])
    out.notes += [f"not compared {k}: {v!r}" for k, v in values.items() if k not in compared]
    run = SimpleNamespace(ctx=ctx, outcome=out, trace=out.trace, python_trace=out.python_trace,
                          work=harness.module("work", cfg["family"], root))
    metrics = {}
    if trace:
        for m in wanted["per_layer"]:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted["end_to_end"]:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    result = {
        "correct": check.correct(compared, out.failed),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": entry["chips"], "memory_peak_bytes": out.memory_peak_bytes},
    }
    if out.trace is not None:
        result["device"].update(busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
        result["breakdown"] = out.trace.breakdown()
    result["compared"] = compared
    result["notes"] = out.notes
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run imported {found}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for line in result.pop("notes"):
        print(line, file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
