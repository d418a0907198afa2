"""Serving over a unix socket: the port's ``InferenceServer`` behind
``engine/server.serve_unix_socket``, and open-loop clients in a
process of their own (``perfbench/traffic/client.py``).

Set-up draws the parameters, builds the server as ``cli/serve`` builds
it (``batch``, ``impl``, the cell's dtype, ``input`` uint8 frames in,
``output`` f16 depth out, no defensive copy of socket frames), serves it
on a socket under the run's temporary directory, and starts the client
process, which connects ``clients`` times and warms each connection up.
The window opens once the client is ready: requests of one frame each
are due at ``rate`` a second in all (``traffic/schedule.py``), each
timed from its due time to its answer.  ``served_frames_per_s`` counts
the answers received inside the window over its seconds: where the rate
lies above what the server sustains, the frames it completes a second;
``served_latency_p95_ms`` is the tail of every request's latency.
Requests still unanswered as the window closes are waited for, up to
``deadline_s`` after the last was due; only those that never come
fail.  The answers of ``sample`` requests a connection, drawn from the
seed, and of each connection's last are kept for the check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench import harness, program
from perfbench.context import Ctx, Outcome, process_age, setup_note
from perfbench.traffic import frames

MAX_SOCK_PATH = 100  # a unix socket's path holds at most 107 bytes


class Served:
    """The server and its accept loop, on a socket of its own."""

    def __init__(self, ctx: Ctx, sd):
        from fastdepth_tpu_torch.engine.server import InferenceServer, serve_unix_socket

        wl, cfg = ctx.workload, ctx.config
        model, params = program.load(cfg, sd, ctx.device)
        self.server = InferenceServer(
            model, params, batch_size=wl["batch"], image_size=tuple(cfg["image_size"]),
            dtype=getattr(torch, wl["dtype"]), impl=wl["impl"],
            input_dtype=np.dtype(wl["input"]), output_dtype=np.dtype(wl["output"]),
            copy_inputs=False, device=ctx.device)
        self.sock = os.path.join(tempfile.gettempdir(), f"perfbench-{os.getpid()}.sock")
        if len(self.sock) > MAX_SOCK_PATH:
            raise RuntimeError(f"the socket path {self.sock!r} is too long for a unix "
                               "socket: set TMPDIR to a shorter directory")
        self.stop = threading.Event()
        ready = threading.Event()
        self.thread = threading.Thread(
            target=serve_unix_socket, args=(self.server, self.sock),
            kwargs={"ready": ready, "stop": self.stop, "log": lambda *a: None}, daemon=True)
        self.thread.start()
        if not ready.wait(120):
            raise RuntimeError("the socket server did not start")

    def close(self):
        self.stop.set()
        self.thread.join(timeout=30)
        self.server.close()


def start_clients(ctx: Ctx, sock: str, rate: float, seconds: float) -> subprocess.Popen:
    """The client process, connected and warmed up (it has printed
    ``ready``)."""
    wl = ctx.workload
    params = {"sock": sock, "seed": ctx.seed, "shape_seed": wl["shape_seed"],
              "conns": wl["clients"], "rate": rate, "seconds": seconds, "ring": wl["ring"],
              "image_size": ctx.config["image_size"], "warmup": wl["warmup_requests"],
              "sample": wl["sample_requests"], "deadline_s": wl["deadline_s"]}
    proc = subprocess.Popen([sys.executable, "-m", "perfbench.traffic.client",
                             json.dumps(params)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, cwd=harness.ROOT)
    line = proc.stdout.readline()
    if line.strip() != b"ready":
        proc.kill()
        proc.wait()
        raise RuntimeError(f"the client process did not start: {line!r}")
    return proc


def open_window(proc: subprocess.Popen, delay: float = 0.05) -> float:
    """Tell the client when the window opens; returns that time."""
    t0 = time.monotonic() + delay
    proc.stdin.write(f"{t0!r}\n".encode())
    proc.stdin.flush()
    return t0


def collect(proc: subprocess.Popen) -> dict:
    """The client's record of every request, once it has ended."""
    head = proc.stdout.readline().split()
    if len(head) != 2 or head[0] != b"result":
        proc.kill()
        proc.wait()
        raise RuntimeError(f"the client process ended without its record: {head!r}")
    body = proc.stdout.read(int(head[1]))
    proc.wait()
    import io

    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def latency_ms(rec: dict) -> np.ndarray:
    """Due time to answer of each answered request, in ms."""
    done = np.isfinite(rec["recv"])
    return (rec["recv"][done] - rec["due"][done]) * 1e3


def answered_in(rec: dict, seconds: float) -> int:
    """The answers received inside the window's first ``seconds``."""
    return int((rec["recv"] <= seconds).sum())


def run(ctx: Ctx) -> Outcome:
    wl, cfg = ctx.workload, ctx.config
    marks = [("imports", process_age())]
    sd = program.draw_params(cfg, ctx.seed, ctx.device)
    marks.append(("weights", process_age()))
    served = Served(ctx, sd)
    marks.append(("program", process_age()))
    procs = []

    def clients(seconds):
        procs.append(start_clients(ctx, served.sock, wl["rate"], seconds))
        return procs[-1]

    try:
        proc = clients(ctx.seconds)
        before = served.server.stats()
        t0 = open_window(proc)
        setup_s = process_age() + (t0 - time.monotonic())
        marks.append(("clients and warm-up", setup_s))
        rec = collect(proc)
        after = served.server.stats()
        counters = {"frames": after["frames"] - before["frames"],
                    "batches": after["batches"] - before["batches"],
                    "batch_size": wl["batch"]}
        traces = {}
        if ctx.trace:
            from perfbench.trace import windows

            def prepare():
                proc = clients(wl["trace_seconds"])

                def go():
                    open_window(proc)
                    return {"frames": int(np.isfinite(collect(proc)["recv"]).sum())}
                return go

            traces = windows(ctx.python_trace, prepare)
        peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        served.close()
    answered = np.isfinite(rec["recv"])
    lat = latency_ms(rec)
    late = (rec["sent"] - rec["due"])[np.isfinite(rec["sent"])] * 1e3
    q = (lambda a, v: float(np.percentile(a, v)) if a.size else float("nan"))
    out = Outcome(
        end_to_end={"served_frames_per_s": answered_in(rec, ctx.seconds) / ctx.seconds,
                    "served_latency_p95_ms": q(lat, 95), "setup_s": setup_s},
        attempted=int(rec["due"].size), failed=int((~answered).sum()), samples={},
        memory_peak_bytes=peak, counters=counters, trace=traces.get("trace"),
        python_trace=traces.get("python_trace"), notes=[setup_note(marks)])
    out.notes.append(f"generator lateness (ms, send - due, {late.size} requests): "
                     f"p50 {q(late, 50)}, p99 {q(late, 99)}, max {q(late, 100)}")
    out.notes.append(f"answers: {answered_in(rec, ctx.seconds)} inside the window, "
                     f"{int(answered.sum())} of {answered.size} in all, the last "
                     f"{q(rec['recv'][answered], 100)} s after the window opened")
    out.notes.append(f"latency (ms, due to answer, {lat.size} answers): p50 {q(lat, 50)}, "
                     f"p95 {q(lat, 95)}, p99 {q(lat, 99)}, max {q(lat, 100)}")
    pool = frames.uint8_frames(wl["ring"], *cfg["image_size"], ctx.seed)
    idx = rec["sample_index"]
    out.samples = {"name": "answer_rel_l2", "params": sd,
                   "inputs": torch.from_numpy(pool[rec["frame"][idx]]),
                   "outputs": torch.from_numpy(rec["sample_answer"])}
    return out
