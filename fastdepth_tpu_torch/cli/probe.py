"""Run the probe catalogue (``engine/probes.py``): every Pallas probe of the
JAX package's ``scripts/``, through the port's kernel and its plain
version, held against each other.

For each tag it prints the scripts' line, ``tag: OK (s) sum=...``, then
the kernel's max|kernel - plain| against its bound and both times: on a
card, device time (CUDA events around a CUDA graph of the calls, which
leaves out the host's launch time, cycling through enough copies of the
operands to read them from device memory) and CUDA-event time of
pipelined calls; on the CPU, where the wrappers run their plain versions,
CPU times.  Beside them: the least time for the call's work at the
H100's published rates (``bound``, bytes or operations) and, where one
PyTorch call computes the same function, that call's device time and the
kernel's time over it.  On a card the run first prints the launch floor
(``engine/benchmark.launch_floor_us``): no call reads faster, so a probe
whose bound is below it is read against the floor.  ``--sweep`` adds the
``dma_copy`` bandwidth sweep and K6's scale rows (card only).

The scripts printed FAIL and carried on, because they bisected a
compiler; this is a check: a probe whose kernel is refused or disagrees
makes the run exit non-zero.

Usage:
    python -m fastdepth_tpu_torch.cli.probe [--tags A_static_dma ...] [--sweep]
        [--calls 20] [--json OUT] --device cuda|cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from fastdepth_tpu_torch.engine import probes as P
from fastdepth_tpu_torch.engine.benchmark import (bound_us, cold_copies, launch_floor_us, sync,
                                                  time_graph, time_pipelined)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the scripts' probe kernels on the port")
    p.add_argument("--tags", nargs="+", default=list(P.PROBES), choices=list(P.PROBES),
                   metavar="TAG", help="probes to run (default: all)")
    p.add_argument("--sweep", action="store_true",
                   help="also run dma_copy's bandwidth sweep and K6's scale rows (needs a card)")
    p.add_argument("--calls", type=int, default=20,
                   help="calls per timing (0: check only, no timing)")
    p.add_argument("--json", default=None, help="write the rows to this JSON file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the kernels; cpu runs their plain versions")
    return p.parse_args(argv)


def probe_row(tag: str, device: torch.device, calls: int = 20) -> dict:
    """One probe: kernel against plain on the same inputs, and both
    times (device and events on a card, CPU on the CPU)."""
    probe = P.PROBES[tag]
    t0 = time.perf_counter()
    args = P.inputs(tag, device)
    got = P.run(tag, device, args)
    want = P.run_plain(tag, device, args)
    sync(device)
    err = (float((got.float() - want.float()).abs().max()) if got.shape == want.shape
           else float("inf"))
    row = {"tag": tag, "kernel": probe.kernel_name, "replaces": probe.replaces,
           "shape": list(got.shape), "dtype": str(got.dtype).replace("torch.", ""),
           "sum": float(got.double().sum()), "max_abs_err": err, "bound": P.bound(tag, want),
           "finite": bool(torch.isfinite(got.float()).all())}
    row["ok"] = row["finite"] and err <= row["bound"]
    nbytes, core, tensor = P.work(tag, args, want)
    row["bound_us"], row["bound_by"] = bound_us(nbytes, core, tensor)
    if calls > 0:
        with torch.inference_mode():
            if device.type == "cuda":
                # distinct copies of the operands, > 2x the L2 per cycle
                sets = [args] + [tuple(a.clone() if a is not None else None for a in args)
                                 for _ in range(cold_copies(nbytes) - 1)]
                row["device_us"] = time_graph(probe.kernel, sets, calls=calls) * 1e6
                row["plain_device_us"] = time_graph(probe.plain, sets, calls=calls) * 1e6
                if probe.library is not None:
                    row["library_device_us"] = time_graph(probe.library, sets,
                                                          calls=calls) * 1e6
            for key, fn in (("", probe.kernel), ("plain_", probe.plain)):
                t = time_pipelined(fn, args, calls=calls, device=device)["mean_s"] * 1e6
                row[f"{key}{'events' if device.type == 'cuda' else 'cpu'}_us"] = t
    row["seconds"] = time.perf_counter() - t0
    return row


def format_row(row: dict) -> str:
    head = (f"{row['tag']}: {'OK' if row['ok'] else 'FAIL'} ({row['seconds']:.0f}s) "
            f"sum={row['sum']:.1f}")
    tail = f"  {row['kernel']} max|diff| {row['max_abs_err']:.3e} (bound {row['bound']:.3e})"
    if "device_us" in row:
        lib = (f", library {row['library_device_us']:.2f}, kernel/library "
               f"{row['device_us'] / row['library_device_us']:.2f}x"
               if "library_device_us" in row else "")
        tail += (f", device {row['device_us']:.2f} us (plain {row['plain_device_us']:.2f}"
                 f"{lib}; bound {row['bound_us']:.2f}, {row['bound_by']}), "
                 f"events {row['events_us']:.2f} us (plain {row['plain_events_us']:.2f})")
    elif "cpu_us" in row:
        tail += f", cpu {row['cpu_us']:.1f} us (plain {row['plain_cpu_us']:.1f})"
    return head + tail


def format_scale_row(r: dict) -> str:
    """One row of :func:`~fastdepth_tpu_torch.engine.probes.compute_sweep`."""
    lib = (f", library {r['library_device_us']:.2f} (kernel/library "
           f"{r['device_us'] / r['library_device_us']:.2f}x)" if "library_device_us" in r
           else ", library none (two calls)")
    return (f"K6 {r['mode']} x {tuple(r['shape'])} -> Cout {r['Cout']}: "
            f"{'OK' if r['ok'] else 'FAIL'} max|diff| {r['max_abs_err']:.3e} (bound "
            f"{r['tol']:.3e}), device {r['device_us']:.2f} us (plain "
            f"{r['plain_device_us']:.2f}{lib}; bound {r['bound_us']:.2f}, {r['bound_by']}, "
            f"{100 * r['share_of_bound']:.1f}% of it)")


def run_probes(tags: List[str], device: torch.device, calls: int = 20,
               log=print) -> List[dict]:
    """:func:`probe_row` for each tag, printed as it goes; a kernel that
    raises gives a FAIL row with the error (and the run goes on)."""
    rows = []
    for tag in tags:
        try:
            row = probe_row(tag, device, calls)
            log(format_row(row))
        except (RuntimeError, ValueError) as e:
            row = {"tag": tag, "kernel": P.PROBES[tag].kernel_name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            log(f"{tag}: FAIL {row['error']}")
        rows.append(row)
    return rows


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    out = {"device": {"type": device.type}}
    if device.type == "cuda":
        from fastdepth_tpu_torch.engine.benchmark import card_info

        out["device"].update(card_info())  # raises without a card
        print(out["device"]["nvidia_smi"])
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        out["launch_floor_us"] = launch_floor_us()
        print(f"launch floor: {out['launch_floor_us']:.2f} us a call (one-element zero_)")
    out["probes"] = run_probes(args.tags, device, args.calls)
    checked = len(out["probes"])
    failed = [r["tag"] for r in out["probes"] if not r["ok"]]
    if args.sweep:
        out["sweep"] = P.copy_sweep(device, calls=max(args.calls, 1))
        print(f"dma_copy sweep (K5, pure copy, full card; {P.L2_NOTE}):")
        for r in out["sweep"]:
            print(f"  {r['bytes'] >> 20:4d} MB, {r['chunk_bytes'] >> 10:3d} KB per slot "
                  f"(script chunk_rows {r['script_chunk_rows']}), prefetch {int(r['prefetch'])}: "
                  f"{r['GBs']:.1f} GB/s device, {r['GBs_events']:.1f} GB/s events")
        out["scale"] = P.compute_sweep(device, calls=max(args.calls, 1))
        for r in out["scale"]:
            print(format_scale_row(r))
        checked += len(out["scale"])
        failed += [f"scale {r['mode']}" for r in out["scale"] if not r["ok"]]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"json -> {args.json}")
    print(f"probes: {checked - len(failed)} OK, {len(failed)} FAIL"
          + (f" ({', '.join(failed)})" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
