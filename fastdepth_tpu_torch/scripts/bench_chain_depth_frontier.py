"""Chain-mode client depth -> (frames/s, p50, p99) frontier — the port's
counterpart of ``scripts/bench_chain_depth_frontier.py``.

The headline single-stream case, chain K = 32 (each frame a batch-1
forward), across client depths {1, 2, 8, 32, 512}: throughput and the
request-latency distribution per depth, so a deployment can pick its
operating point, and the knee (``_serving.knee``).  Engine level
(``InferenceServer.submit`` in process, uint8 in / f16 out, bf16), one
fresh server per depth whose counters restart after its warm-up.

A short window is not padded: where the script's chain graph ran all K
rows of a window (31 pad rows at depth 1), the port's chain server runs
one batch-1 forward per real frame (``engine/server.py``), so a depth-1
request costs one forward.  ``launches`` counts K1 and K4 over every
request, warm-ups included, and its ``forwards`` are those frames.

    python -m fastdepth_tpu_torch.scripts.bench_chain_depth_frontier [--k 32]
        [--depths 1,2,8,32,512] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json

from fastdepth_tpu_torch.scripts import _serving as S

WINDOW_PADDING = ("none: a window of n < K frames runs n batch-1 forwards "
                  "(the script's chain graph ran K rows, K - n of them padding)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hw", type=int, default=S.HW)
    p.add_argument("--k", type=int, default=32, help="chain window length")
    p.add_argument("--depths", default="1,2,8,32,512")
    p.add_argument("--max-frames", type=int, default=2048,
                   help="frames at the deepest depths (depth * 64 below it, at least 64)")
    S.add_common(p, "b1_depth_frontier_h100.json")
    return p.parse_args(argv)


def build_server(model, params, *, k: int, depth: int, hw: int, **kw):
    """The script's chain server for one depth: a queue of
    ``max(4 k, depth + k)`` (``kw`` on top)."""
    return S.make_server(model, params, k, chain=True, image_size=(hw, hw),
                         max_queue=max(4 * k, depth + k), **kw)


def run_depth(srv, frame, depth: int, max_frames: int) -> dict:
    """Warm up (``2 k`` frames), restart the server's counters, then one
    client ``depth`` requests deep; the depth's row."""
    for fut in [srv.submit(frame) for _ in range(2 * srv.batch_size)]:
        fut.result(timeout=S.RESULT_S)
    with srv._lat_lock:
        srv._lat.clear()
    # the drainer is idle: every warm-up future has resolved
    srv._frames = 0
    srv._batches = 0
    frames = max(64, min(max_frames, depth * 64))
    dt = S.pipelined(srv.submit, frame, frames, depth)
    st = srv.stats()
    return {"depth": depth, "frames": frames, "fps": round(frames / dt, 1),
            "ms_per_frame": round(dt / frames * 1e3, 3),
            "mean_occupancy": st["mean_occupancy"], "latency_ms": st.get("latency_ms")}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = S.check_device(args.device)
    model, params = S.flagship()
    frame = S.seeded_frame(args.hw)
    results = {"surface": "engine (InferenceServer.submit in-process), chain mode",
               "k": args.k, "hw": args.hw, "dtype": "bf16 compute, uint8 in / fp16 out",
               "rows": []}
    counted = {"K1": 0, "K4": 0, "replays": 0, "forwards": 0}
    for depth in (int(d) for d in args.depths.split(",")):
        srv = build_server(model, params, k=args.k, depth=depth, hw=args.hw,
                           device=args.device)
        try:
            before = S.kernel_counts()
            row = run_depth(srv, frame, depth, args.max_frames)
            got = S.launches(before, 2 * args.k + row["frames"])  # the warm-up's too
        finally:
            srv.close()
        counted = {k: counted[k] + got[k] for k in counted}
        results["rows"].append(row)
        print(json.dumps({**row, "card": card}), flush=True)
    knee = S.knee(results["rows"])
    if knee is not None:
        results["knee"] = knee
        print(json.dumps({**knee, "card": card}), flush=True)
    results.update(window_padding=WINDOW_PADDING, card=card, launches=counted)
    S.write_json(args.out, results)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
