"""The serving sweep: one server, the open-loop load at each of several
rates in turn, ``--repeats`` windows a rate, and from them the knee and
the capacity.

    python -m perfbench.sweep --workload fastdepth.serve-socket --seed 1 --seconds 8 \\
        --rates 200,400,800 --repeats 3 --knee-p95-ms 33

Each window prints one line: the latency percentiles (due time to
answer), the answers received inside the window a second
(``frames_per_s``, as the cell counts them), the generator's lateness,
and whether the backlog grew: the median latency of the last fifth of
the requests (by due time) above the first fifth's by more than
``--knee-p95-ms``, or a request never answered.  A rate passes where
every window of it keeps its p95 within ``--knee-p95-ms`` with no
growing backlog.  The last line gives the knee, the highest rate that
passes with every lower rate passing too (null where the lowest fails),
and the capacity, the largest median ``frames_per_s`` of a rate.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np

from perfbench import harness, program
from perfbench.context import Ctx


def window_row(rec: dict, rate: float, seconds: float, knee_p95_ms: float) -> dict:
    """One window's readings from the client's record."""
    entry = harness.module("entries", "serve_socket")
    lat = entry.latency_ms(rec)
    order = np.argsort(rec["due"])
    tail = (rec["recv"] - rec["due"])[order] * 1e3
    fifth = max(1, len(order) // 5)
    first, last = float(np.nanmedian(tail[:fifth])), float(np.nanmedian(tail[-fifth:]))
    answered = int(np.isfinite(rec["recv"]).sum())
    p95 = float(np.percentile(lat, 95)) if lat.size else float("inf")
    late = (rec["sent"] - rec["due"])[np.isfinite(rec["sent"])] * 1e3
    growing = answered < rec["due"].size or last - first > knee_p95_ms
    return {"rate": rate, "requests": int(rec["due"].size), "answered": answered,
            "frames_per_s": entry.answered_in(rec, seconds) / seconds,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": p95,
            "p99_ms": float(np.percentile(lat, 99)),
            "first_fifth_p50_ms": first, "last_fifth_p50_ms": last,
            "late_p99_ms": float(np.percentile(late, 99)), "backlog_grows": growing,
            "passes": p95 <= knee_p95_ms and not growing}


def summary(rows: list) -> dict:
    """The knee and the capacity over every window's row."""
    rates = sorted({r["rate"] for r in rows})
    passes = {x: all(r["passes"] for r in rows if r["rate"] == x) for x in rates}
    knee = None
    for x in rates:
        if not passes[x]:
            break
        knee = x
    fps = {x: statistics.median(r["frames_per_s"] for r in rows if r["rate"] == x)
           for x in rates}
    capacity = max(fps, key=fps.get)
    return {"knee_rps": knee, "passes": {str(x): passes[x] for x in rates},
            "median_frames_per_s": {str(x): fps[x] for x in rates},
            "capacity_frames_per_s": fps[capacity], "capacity_at_rate": capacity}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True, help="comma-separated, requests a second")
    p.add_argument("--repeats", type=int, default=3, help="windows a rate")
    p.add_argument("--knee-p95-ms", type=float, default=33.0,
                   help="the p95 a rate may reach and pass (33 ms: one frame of a 30 fps camera)")
    args = p.parse_args(argv)
    entry = harness.module("entries", "serve_socket")
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    ctx = Ctx(cell=args.workload, workload=wl, config=cfg, seed=args.seed,
              seconds=args.seconds, trace=False)
    served = entry.Served(ctx, program.draw_params(cfg, args.seed, "cuda"))
    rows = []
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            for _ in range(args.repeats):
                proc = entry.start_clients(ctx, served.sock, rate, args.seconds)
                entry.open_window(proc)
                rows.append(window_row(entry.collect(proc), rate, args.seconds,
                                       args.knee_p95_ms))
                print(json.dumps(rows[-1]), flush=True)
    finally:
        served.close()
    print(json.dumps(summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
