"""The client process of a serving cell: open-loop load over several
connections from one thread.

    python -m perfbench.traffic.client '<json parameters>'

It connects ``conns`` times to the unix socket ``sock``, sends
``warmup`` requests on each and waits for their answers, and prints
``ready``.  It then reads the window's opening time (``time.monotonic``,
which every process of the host shares) from its standard input, sends
each request when it is due (``schedule.due_times``) whatever is still
unanswered, and reads answers as they come.  It stops once every
request is answered or ``deadline_s`` after the last was due, and
writes an ``.npz`` to its standard output, after a line
``result <bytes>``: for each request its connection, due, send and
answer times (NaN where none came) and frame; and the answers of the
sampled requests.
"""

from __future__ import annotations

import io
import json
import selectors
import socket
import sys
import time

import numpy as np

from perfbench.traffic import frames, schedule, wire

SPIN_S = 0.0015  # closer to a due time than this, poll instead of sleeping


def main(p: dict) -> int:
    h, w = p["image_size"]
    pool = frames.uint8_frames(p["ring"], h, w, p["seed"])
    payloads = [wire.encode(f) for f in pool]
    socks = []
    for _ in range(p["conns"]):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(p["sock"])
        socks.append(s)
    for i in range(p["warmup"]):
        for c, s in enumerate(socks):
            s.sendall(payloads[(i + c) % len(payloads)])
        for s in socks:
            wire.recv_one(s)
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())

    dues = schedule.due_times(p["rate"], p["seconds"], p["seed"], p["shape_seed"], p["conns"])
    due = t0 + np.concatenate(dues)
    fid = np.concatenate([schedule.frame_ids(len(d), p["ring"], p["seed"], c)
                          for c, d in enumerate(dues)])
    conn = np.concatenate([np.full(len(d), c) for c, d in enumerate(dues)])
    n = len(due)
    sent = np.full(n, np.nan)
    recv = np.full(n, np.nan)
    # each connection's requests in due order (a connection answers in order)
    queues = [np.flatnonzero(conn == c)[np.argsort(due[conn == c], kind="stable")]
              for c in range(p["conns"])]
    keep = set()
    for c, q in enumerate(queues):
        keep.update(int(q[j]) for j in schedule.sampled(len(q), p["sample"], p["seed"], c))
    answers = {}

    sel = selectors.DefaultSelector()
    state = []
    for c, s in enumerate(socks):
        s.setblocking(False)
        st = {"sock": s, "q": queues[c], "next": 0, "got": 0, "out": None,
              "dec": wire.Decoder(), "open": True, "events": selectors.EVENT_READ}
        state.append(st)
        sel.register(s, selectors.EVENT_READ, st)
    end = due.max() + p["deadline_s"]
    while True:
        now = time.monotonic()
        pending = [st for st in state if st["open"] and st["got"] < len(st["q"])]
        if not pending or now > end:
            break
        wait = end - now
        for st in state:
            if st["out"] is None and st["next"] < len(st["q"]):
                k = st["q"][st["next"]]
                if due[k] <= now:
                    sent[k] = now
                    st["out"] = memoryview(payloads[fid[k]])
                else:
                    wait = min(wait, due[k] - now)
            events = selectors.EVENT_READ | (selectors.EVENT_WRITE if st["out"] is not None
                                             else 0)
            if events != st["events"]:
                sel.modify(st["sock"], events, st)
                st["events"] = events
        for key, mask in sel.select(0 if wait < SPIN_S else wait - SPIN_S):
            st = key.data
            if mask & selectors.EVENT_WRITE and st["out"] is not None:
                try:
                    st["out"] = st["out"][st["sock"].send(st["out"]):]
                except BlockingIOError:
                    pass
                if not len(st["out"]):
                    st["out"] = None
                    st["next"] += 1
            if mask & selectors.EVENT_READ:
                try:
                    data = st["sock"].recv(1 << 20)
                except BlockingIOError:
                    continue
                if not data:
                    st["open"] = False
                    continue
                got = st["dec"].feed(data)
                t = time.monotonic()
                for arr in got:
                    k = int(st["q"][st["got"]])
                    recv[k] = t
                    if k in keep:
                        answers[k] = arr
                    st["got"] += 1
    for s in socks:
        s.close()
    keys = sorted(answers)
    buf = io.BytesIO()
    np.savez(buf, conn=conn, due=due - t0, sent=sent - t0, recv=recv - t0,
             frame=fid, sample_index=np.asarray(keys, np.int64),
             sample_answer=(np.stack([answers[k] for k in keys]) if keys
                            else np.zeros((0, h, w, 1), np.float16)))
    out = buf.getvalue()
    sys.stdout.write(f"result {len(out)}\n")
    sys.stdout.flush()
    sys.stdout.buffer.write(out)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
