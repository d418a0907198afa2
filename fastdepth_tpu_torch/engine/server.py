"""Micro-batching inference server on the PyTorch/CUDA port — counterpart
of ``fastdepth_tpu/engine/server.py``.

The reference's deploy story ends at a one-shot TVM graph run
(deploy/tx2_run_tvm.py:35-40).  A serving front end needs the piece in
between: many independent single-frame requests, one fixed-shape
forward.  Requests queue on the host; a drainer thread packs up to
``batch_size`` frames into the fixed batch (padding the tail with
zeros), runs ONE forward on the card, and resolves per-request futures.
On the flagship, ``impl='auto'`` runs the decoder levels through K1 and
the head through K4 (``engine/aot._pick_apply``).

The wire protocol (length-prefixed ``.npy`` frames over unix and TCP
sockets, the zero-length stats op) is the JAX package's, byte for byte:
clients and servers of either package talk to each other.  This module
keeps its own copy of that numpy-only half.

Over a mesh (``mesh=``, ``parallel/mesh.py``: ``data``, ``space`` or
both) every rank constructs the server.  Rank 0 is the front end: the
queue, the drainer, the socket.  For each packed batch it broadcasts a
small header (go and the real-frame count), then the batch; every rank
computes its ``(data, space)`` block (its rows of the batch, its rows of
the height through the height-sharded forward), and the blocks are
gathered back to rank 0.  The other ranks run a follower loop that
answers those broadcasts until rank 0's ``close()`` sends a stop header;
while idle rank 0 sends a heartbeat header every :data:`HEARTBEAT_S`, so
a group timeout longer than that only fires when a rank is gone, and a
failed collective brings the server down (``failed``) instead of
hanging it.  Every rank issues the same collectives in the same order.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from fastdepth_tpu_torch.engine.aot import _prepare, normalize
from fastdepth_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, block_of

# the mesh server's headers: [command, real frames]
_STOP, _BATCH, _BEAT = 0, 1, 2
# seconds between rank 0's idle heartbeats to the follower ranks
HEARTBEAT_S = 5.0
CHAIN_DATA_REFUSED = (
    "chain mode executes the window SEQUENTIALLY in-graph "
    "(batch-1 forwards under lax.map) — a 'data' mesh axis "
    "would shard the scan axis.  Use chain with no mesh or "
    "a 'space'-only mesh (spatial partitioning cuts each "
    "frame's latency; the window is the amortization).")


def _resolve_future(fut: Future, value=None, exc=None) -> None:
    """Resolve a client future, immune to a racing ``cancel()`` AND to a
    second resolver: ``set_running_or_notify_cancel`` atomically claims
    the future (after which cancel can no longer succeed) or reports it
    already cancelled — a bare ``cancelled()`` check would TOCTOU-race.
    If another thread already claimed/finished it (the submit-vs-close
    race resolves the same future from both sides by design), the
    InvalidStateError means the other side won; first resolution
    sticks."""
    try:
        if not fut.set_running_or_notify_cancel():
            return
    except (RuntimeError, InvalidStateError):
        # RuntimeError: already claimed (RUNNING) or FINISHED;
        # InvalidStateError: resolved between our claim and set below.
        # Either way the other resolver won.
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(value)


class _Slot:
    """One batch's host buffers, reused once its batch has resolved:
    packed input frames and the prediction copied back (page-locked on
    the card, so both copies run asynchronously on the drainer's stream),
    and the event recorded after the batch's last copy."""

    def __init__(self, in_shape, in_dtype, out_shape, out_dtype, device: torch.device):
        pin = device.type == "cuda"
        self.host_in = torch.empty(in_shape, dtype=in_dtype, pin_memory=pin)
        self.host_out = torch.empty(out_shape, dtype=out_dtype, pin_memory=pin)
        self.in_np = self.host_in.numpy()
        self.out_np = self.host_out.numpy()
        self.done = torch.cuda.Event() if pin else None


class InferenceServer:
    """Queue + drainer over a fixed-batch forward.

    ``submit(rgb_hwc_float)`` returns a Future resolving to the HW1
    depth prediction.  The drainer packs whatever is queued (up to
    ``batch_size``) the moment it is free — latency under light load (a
    lone request rides a padded batch immediately), throughput under
    pressure (full batches back-to-back, ``pipeline_depth`` in flight).
    """

    def __init__(
        self,
        model,
        params,
        *,
        batch_size: int = 8,
        image_size=(224, 224),
        dtype: torch.dtype = torch.float32,
        fold_bn: bool = True,
        impl: str = "auto",
        tuning=None,
        max_queue: int = 1024,
        input_dtype=np.float32,
        output_dtype=np.float32,
        pipeline_depth: int = 2,
        mesh=None,
        chain: bool = False,
        copy_inputs: bool = True,
        close_timeout: float = 60.0,
        device: Union[str, torch.device, None] = None,
    ):
        """``params``: the tree from ``Model.load``.  It is folded (in
        f32, before the cast to ``dtype``) and the forward picked as for
        ``Evaluator`` (``engine/aot._prepare``; f32 is true f32).  With
        ``fold_bn=False`` an unfolded tree keeps its BatchNorm and
        ``impl='auto'`` serves the straight forward, whose eval-mode
        BatchNorm leaves every row independent of the zero-padded tail.
        ``input_dtype=np.uint8`` accepts raw [0,255] frames and
        normalizes (/255) on the device (:func:`normalize`) — 4x less
        socket and host-to-device traffic.  ``output_dtype=np.float16``
        halves the prediction payload (cast on the device after the
        forward).  ``chain=True`` runs each packed window of up to
        ``batch_size`` frames as sequential batch-1 forwards on the
        drainer's stream, one wait per window.  ``copy_inputs=False``
        skips submit()'s defensive frame copy — only for in-process
        clients that never mutate a frame after submitting it.
        ``device``: 'cuda' (the default) runs the kernels (the card must
        exist: there is no CPU fallback); 'cpu' their plain versions.
        ``mesh``: serve over the mesh (module docstring), on its device;
        ``batch_size`` divides by its ``data`` axis, the image height by
        its ``space`` axis, and ``chain`` takes no ``data`` axis larger
        than 1 (the JAX server's checks).  Every rank constructs the
        server; on rank 0 it serves, on the others it follows until rank
        0 closes (a follower's :meth:`close` blocks until then).
        ``impl='mixed'`` runs each decoder level on its autotuned winner
        from ``tuning`` (a record path or a winner map, as for
        ``Evaluator``)."""
        space = None
        if mesh is not None:
            n_data = mesh.shape.get(DATA_AXIS, 1)
            if batch_size % n_data:
                raise ValueError(
                    f"batch_size {batch_size} must divide by the mesh's "
                    f"{n_data}-way '{DATA_AXIS}' axis")
            n_space = mesh.shape.get(SPACE_AXIS, 1)
            if image_size[0] % n_space:
                raise ValueError(
                    f"image height {image_size[0]} must divide by the "
                    f"mesh's {n_space}-way '{SPACE_AXIS}' axis")
            if chain and n_data > 1:
                raise ValueError(CHAIN_DATA_REFUSED)
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
            device, space = mesh.device, mesh.partition()
        self.mesh = mesh
        self.failed = threading.Event()  # a mesh collective failed: the server is down
        self.fatal_error: Optional[BaseException] = None
        self._leader = mesh is None or dist.get_rank() == 0
        self._copy_inputs = bool(copy_inputs)
        self.input_dtype = np.dtype(input_dtype)
        if self.input_dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(f"input_dtype must be float32 or uint8, got {input_dtype}")
        self.output_dtype = np.dtype(output_dtype)
        if self.output_dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
            raise ValueError(
                f"output_dtype must be float32 or float16, got {output_dtype}")
        self.chain = bool(chain)
        self.device = torch.device("cuda" if device is None else device)
        # chain == batch-1 compute: the forward is picked for batch 1
        self.params, apply = _prepare(model, params,
                                      batch_size=1 if self.chain else batch_size,
                                      dtype=dtype, fold_bn=fold_bn, impl=impl,
                                      device=self.device, space=space, tuning=tuning)
        out_dtype = torch.float16 if self.output_dtype == np.float16 else torch.float32
        uint8_in = self.input_dtype == np.uint8

        def forward(x):
            x = normalize(x, dtype) if uint8_in else x.to(dtype)
            return apply(self.params, x).to(out_dtype)

        self._forward = forward
        self.pipeline_depth = pipeline_depth
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        h, w = self.image_size
        # pending batches (at most pipeline_depth after each dispatch) and
        # the one being packed each hold a slot
        in_dtype = torch.uint8 if uint8_in else torch.float32
        self._in_shape, self._in_dtype = (batch_size, h, w, 3), in_dtype
        self._slots = [_Slot((batch_size, h, w, 3), in_dtype, (batch_size, h, w, 1), out_dtype,
                             self.device) for _ in range(max(pipeline_depth, 0) + 1)
                       ] if self._leader else []
        self._stream = None
        if self.device.type == "cuda":
            from fastdepth_tpu_torch.ops.cuda import _build

            _build.load()  # build the kernels now: a build failure raises here
            self._stream = torch.cuda.Stream(self.device)
            # the params were put on the device on this thread's stream
            torch.cuda.synchronize(self.device)
        self._frames = 0
        self._batches = 0
        self._t_start = time.monotonic()
        # last-N request latencies (submit -> result resolved): enough for
        # stable p99 at a bounded footprint; guarded by _lat_lock because
        # resolve() (drainer) and stats() (any client thread) race on it
        self._lat = collections.deque(maxlen=4096)
        self._lat_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._close_timeout = float(close_timeout)
        # True while the drainer holds dispatched-but-unresolved work;
        # single writer (drainer), read heuristically by close()
        self._busy = False
        self._thread = threading.Thread(target=self._drain if self._leader else self._follow,
                                        daemon=True)
        self._thread.start()

    # ---- client side ----

    def submit(self, rgb: np.ndarray) -> Future:
        """Enqueue one HWC RGB frame of the server's ``input_dtype``;
        returns a Future of the (H, W, 1) ``output_dtype`` prediction."""
        h, w = self.image_size
        # own the frame: the drainer packs it into the batch at an
        # unbounded time later (queue wait), so a client reusing its
        # read buffer would silently answer request k with frame k+1.
        # copy_inputs=False opts out for in-process perf clients that
        # never mutate a submitted frame.
        rgb = np.asarray(rgb)
        # validate on the view BEFORE the owning copy so rejected frames
        # don't pay a ~600KB memcpy
        if rgb.dtype != self.input_dtype:
            raise ValueError(
                f"expected {self.input_dtype} frames "
                f"(server input_dtype), got {rgb.dtype}")
        if rgb.shape != (h, w, 3):
            raise ValueError(f"expected ({h}, {w}, 3) HWC rgb, got {rgb.shape}")
        if not self._leader:
            raise RuntimeError("submit() on a follower rank: rank 0 serves the mesh")
        if self._copy_inputs:
            rgb = np.array(rgb, copy=True)
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._q.put((rgb, fut, time.perf_counter()))
        if self._stop.is_set():
            # close() may have raced between the check above and the put:
            # its post-join drain might already be past our item, which
            # would leave the future unresolved forever.  Resolve it as
            # closed ourselves — _resolve_future is idempotent, so if the
            # drain (or the drainer's last pass) got there first, the
            # earlier resolution stands.
            _resolve_future(fut, exc=RuntimeError("server is closed"))
        return fut

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        return self.submit(rgb).result()

    def stats(self) -> dict:
        """Served-so-far counters + request-latency distribution.
        ``mean_occupancy`` is the average fraction of the fixed batch
        that carried real frames — low values mean the batch size outruns
        the offered load.  ``latency_ms`` covers the last ≤4096 requests,
        measured submit -> result resolved (queue wait + pack + device +
        copy back — what a client actually experiences); also the wire
        protocol's health/stats op payload (a zero-length frame,
        :func:`request_stats`)."""
        # read _frames BEFORE _batches (and the drainer increments
        # _batches before _frames): any interleaving then pairs a stale
        # frame count with a fresh-or-stale batch count, so occupancy can
        # transiently UNDERcount but never exceed 1.0
        f = self._frames
        b = self._batches
        with self._lat_lock:
            lat = np.asarray(self._lat, np.float64)
        out = {
            "status": "closed" if self._stop.is_set() else "ok",
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "frames": f,
            "batches": b,
            "batch_size": self.batch_size,
            "chain": self.chain,
            "mean_occupancy": round(f / (b * self.batch_size), 3)
            if b else 0.0,
            "queued": self._q.qsize(),
        }
        if lat.size:
            p50, p99 = np.percentile(lat, [50, 99])
            out["latency_ms"] = {
                "count": int(lat.size),
                "mean": round(float(lat.mean()) * 1e3, 3),
                "p50": round(float(p50) * 1e3, 3),
                "p99": round(float(p99) * 1e3, 3),
                "max": round(float(lat.max()) * 1e3, 3),
            }
        return out

    # ---- drainer ----

    def _run(self, slot: _Slot, n: int) -> None:
        """Enqueue one packed batch of ``n`` frames on the current stream:
        the copy in, the forward (``n`` batch-1 forwards in chain mode:
        the padded tail is never read), the copy back, then the slot's
        event.  Nothing here waits for the device."""
        x = slot.host_in.to(self.device, non_blocking=True)  # the CPU: no copy
        if self.mesh is not None:
            self._header(_BATCH, n)
            dist.broadcast(x, 0)
            out = self._mesh_step(x, n)
            slot.host_out[:out.shape[0]].copy_(out, non_blocking=True)
        elif self.chain:
            out = torch.cat([self._forward(x[i:i + 1]) for i in range(n)])
            slot.host_out[:n].copy_(out, non_blocking=True)
        else:
            slot.host_out.copy_(self._forward(x), non_blocking=True)
        if slot.done is not None:
            slot.done.record()

    def _header(self, command: int, n: int = 0) -> torch.Tensor:
        """Broadcast (rank 0) or receive a ``[command, frames]`` header."""
        # filled on the device: a copy from the host would wait for the
        # stream's earlier batches and end the drainer's pipelining
        header = torch.full((2,), n, dtype=torch.int64, device=self.device)
        header[:1].fill_(command)
        dist.broadcast(header, 0)
        self._last_collective = time.monotonic()
        return header

    def _mesh_step(self, x: torch.Tensor, n: int) -> Optional[torch.Tensor]:
        """Every rank's share of one packed batch ``x`` (the whole batch,
        on every rank): its ``(data, space)`` block through the forward
        (``n`` batch-1 forwards in chain mode), the blocks gathered to
        rank 0, which returns the assembled prediction (the others None)."""
        block = block_of(x, self.mesh)
        if self.chain:
            out = torch.cat([self._forward(block[i:i + 1]) for i in range(n)])
        else:
            out = self._forward(block)
        out = out.contiguous()
        parts = ([torch.empty_like(out) for _ in range(dist.get_world_size())]
                 if self._leader else None)
        dist.gather(out, parts, dst=0)
        if not self._leader:
            return None
        # rank d * S + s holds batch block d, height block s
        n_space = self.mesh.space_size
        rows = [torch.cat(parts[d * n_space:(d + 1) * n_space], 1)
                for d in range(len(parts) // n_space)]
        return torch.cat(rows, 0)

    def _follow(self):
        """A follower rank's loop: answer rank 0's headers (a batch: its
        broadcast, this rank's block, the gather) until the stop header.
        A failed collective ends it and sets ``failed``."""
        ctx = (torch.cuda.stream(torch.cuda.Stream(self.device))
               if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with torch.inference_mode(), ctx:
                while True:
                    command, n = self._header(_STOP).tolist()
                    if command == _STOP:
                        return
                    if command == _BATCH:
                        x = torch.empty(self._in_shape, dtype=self._in_dtype,
                                        device=self.device)
                        dist.broadcast(x, 0)
                        self._mesh_step(x, n)
        except Exception as e:  # the leader or a peer is gone
            self._fatal(e)

    def _fatal(self, exc: BaseException) -> None:
        """A mesh collective failed: the group cannot go on, so the server
        stops (``failed`` set; the serve CLI exits on it)."""
        self.fatal_error = exc
        self.failed.set()
        self._stop.set()

    def _drain(self):
        """The drainer thread: inference mode, autocast state, the current
        device and stream are all per thread, so they are entered here.
        On the card every batch runs on the server's own stream."""
        with torch.inference_mode():
            if self._stream is None:
                self._loop()
            else:
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    self._loop()
            if self.mesh is not None and not self.failed.is_set():
                try:
                    self._header(_STOP)  # the followers' loops end
                except Exception as e:
                    self._fatal(e)

    def _loop(self):
        """Pack + dispatch loop, pipelined ``pipeline_depth`` batches deep.

        Waiting for a batch is the expensive host step, so batch k+1 is
        ENQUEUED before batch k is waited for — the card never starves on
        the host's wait, which is on batch k's event alone (no device-wide
        synchronize).  Under light load (nothing else queued) pending
        batches resolve immediately, keeping single-request latency at
        one forward."""
        pending = collections.deque()  # (slot, items)
        free = collections.deque(self._slots)

        def resolve(entry):
            slot, items = entry
            try:
                if slot.done is not None:
                    slot.done.synchronize()  # this batch's copies and kernels
                # copies: the slot is reused by a later batch
                preds = [slot.out_np[i].copy() for i in range(len(items))]
            except Exception as e:  # resolve, don't wedge the clients
                for _, fut, _ in items:
                    _resolve_future(fut, exc=e)
                return
            finally:
                free.append(slot)
            now = time.perf_counter()
            with self._lat_lock:
                self._lat.extend(now - t0 for _, _, t0 in items)
            for (_, fut, _), pred in zip(items, preds):
                _resolve_future(fut, value=pred)

        self._last_collective = time.monotonic()
        while not self._stop.is_set():
            try:
                if not pending:
                    self._busy = False
                first = self._q.get(timeout=0.02 if pending else 0.1)
            except queue.Empty:
                while pending:
                    resolve(pending.popleft())
                if (self.mesh is not None
                        and time.monotonic() - self._last_collective > HEARTBEAT_S):
                    try:
                        self._header(_BEAT)
                    except Exception as e:
                        self._fatal(e)
                continue
            if first is None:
                break
            self._busy = True
            items = [first]
            # pack whatever else is already waiting, up to the batch
            while len(items) < self.batch_size:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                items.append(nxt)
            # a free slot: its earlier batch has resolved, so no pending
            # copy still reads its input buffer
            slot = free.popleft()
            for i, (rgb, _, _) in enumerate(items):
                slot.in_np[i] = rgb
            slot.in_np[len(items):] = 0
            try:
                self._run(slot, len(items))
            except Exception as e:
                if self.mesh is not None:  # a collective may have failed: stop
                    self._fatal(e)
                if self._stream is not None:
                    try:  # let an enqueued copy finish before the slot is reused
                        self._stream.synchronize()
                    except RuntimeError:
                        pass  # the same fault, already reported below
                free.append(slot)
                for _, fut, _ in items:
                    _resolve_future(fut, exc=e)
                continue
            pending.append((slot, items))
            self._batches += 1
            self._frames += len(items)
            if self._q.empty():
                while pending:  # light load: resolve now, lowest latency
                    resolve(pending.popleft())
            else:
                while len(pending) > self.pipeline_depth:
                    resolve(pending.popleft())
        while pending:
            resolve(pending.popleft())
        self._busy = False

    def close(self):
        if not self._leader:
            self._thread.join()  # the follower loop ends at rank 0's stop header
            return
        self._stop.set()
        try:
            # never block: on a FULL queue the drainer has already seen
            # the stop flag (it re-checks every get timeout) and will not
            # consume a sentinel — a blocking put() would deadlock close()
            # and every submitter stuck in _q.put() behind it
            self._q.put_nowait(None)
        except queue.Full:
            pass
        # busy-aware join: while the drainer holds in-flight work, wait up
        # to close_timeout so queued requests finish serving instead of
        # being failed early; an IDLE drainer exits within one get
        # timeout, so a couple of short joins suffice — and a drainer
        # wedged on a hung device holds close() for at most
        # close_timeout, not forever (pass close_timeout= to tune)
        deadline = time.monotonic() + self._close_timeout
        while True:
            self._thread.join(timeout=5)
            if not self._thread.is_alive():
                break
            if not self._busy or time.monotonic() >= deadline:
                self._thread.join(timeout=5)
                break
        # fail anything that raced in behind the sentinel — its future
        # would otherwise never resolve and hang a waiting client
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _resolve_future(item[1], exc=RuntimeError("server is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_address(spec: str):
    """Socket spec -> ('unix', path) | ('tcp', host, port).

    TCP iff the spec is ``host:port`` with no path separator (e.g.
    ``127.0.0.1:7000``, ``[::1]:7000``); anything else is a unix path —
    so existing ``--socket /tmp/fd.sock`` usage is unchanged."""
    if "/" not in spec and ":" in spec:
        host, _, port = spec.rpartition(":")
        # a bare IPv6 address ('::1') must NOT parse as host '::' port
        # '1' — an un-bracketed host with ':' in it is never a valid
        # host:port spec, so fall through to the unix-path branch (which
        # fails fast on connect with a clear error; IPv6 needs brackets)
        bracketed = host.startswith("[") and host.endswith("]")
        if port.isdigit() and (":" not in host or bracketed):
            return ("tcp", host.strip("[]") or "127.0.0.1", int(port))
    return ("unix", spec)


def serve_unix_socket(
    server: InferenceServer,
    sock_path: str,
    *,
    ready: Optional[threading.Event] = None,
    stop: Optional[threading.Event] = None,
    log=print,
):
    """Accept loop: length-prefixed ``.npy`` frames over a unix socket.

    Protocol per request: 4-byte big-endian length + ``np.save`` bytes of
    an (H, W, 3) array of the server's ``input_dtype`` (float32 by
    default; uint8 for a ``--uint8`` server — a wrong dtype/shape drops
    the connection with a server-side log); the response is the same
    framing around the (H, W, 1) ``output_dtype`` prediction (float32,
    or float16 under ``--half-output``).  One connection may stream many
    requests; each is answered in order.
    """
    import os
    import socket

    if os.path.exists(sock_path):
        # refuse to hijack a LIVE daemon's socket; unlink only stale ones
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.connect(sock_path)
            raise RuntimeError(
                f"{sock_path} already has a live server — pick another "
                "--socket path or stop the running daemon")
        except (ConnectionRefusedError, FileNotFoundError):
            try:
                os.unlink(sock_path)  # stale leftover from a dead process
            except FileNotFoundError:
                pass  # vanished between probe and unlink (owner cleanup)
        finally:
            probe.close()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(sock_path)
    except BaseException:
        srv.close()  # a bind failure must not leak the listening fd
        raise

    def cleanup():
        if os.path.exists(sock_path):
            os.unlink(sock_path)

    serve_socket(server, srv, name=sock_path, ready=ready, stop=stop,
                 log=log, cleanup=cleanup)


def serve_tcp(
    server: InferenceServer,
    host: str,
    port: int,
    *,
    ready: Optional[threading.Event] = None,
    stop: Optional[threading.Event] = None,
    log=print,
):
    """Same protocol/accept loop over TCP (remote clients; the unix
    socket stays the single-host default).  ``port=0`` binds an
    ephemeral port; the bound address is logged and exposed as
    ``server.bound_address`` before ``ready`` is set.  The address
    family follows the host (IPv4 or IPv6 — getaddrinfo, not a
    hard-coded AF_INET)."""
    import socket

    family, _, _, _, bind_addr = socket.getaddrinfo(
        host, port, type=socket.SOCK_STREAM, flags=socket.AI_PASSIVE)[0]
    srv = socket.socket(family, socket.SOCK_STREAM)
    try:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(bind_addr)
        server.bound_address = srv.getsockname()[:2]
    except BaseException:
        srv.close()  # a bind failure must not leak the listening fd
        raise
    serve_socket(server, srv, name="%s:%d" % server.bound_address,
                 ready=ready, stop=stop, log=log)


def serve_socket(
    server: InferenceServer,
    srv,
    *,
    name: str = "",
    ready: Optional[threading.Event] = None,
    stop: Optional[threading.Event] = None,
    log=print,
    cleanup=None,
):
    """Shared accept loop over a bound (not yet listening) socket."""
    import socket

    stop = stop or threading.Event()
    srv.listen(64)
    srv.settimeout(0.2)
    if ready is not None:
        ready.set()
    log(f"=> serving on {name} (batch {server.batch_size})")
    # live connections: handler readers block in recv with no timeout, so
    # a stop request must shutdown() them to unblock (shutdown, not
    # close — close under a concurrent sendall re-uses a dead fd in
    # CPython; each handler's own finally does the close)
    conns: set = set()
    conns_lock = threading.Lock()

    def handle(conn):
        # Pipelined per-connection protocol: the reader thread (this one)
        # submits every frame as it arrives and queues the future; a
        # writer thread streams results back in request order.  A client
        # may therefore keep many requests in flight on one connection —
        # that is what lets a single client fill the server's fixed
        # batch (the reference's runner is strictly one-shot,
        # deploy/tx2_run_tvm.py:35-40).
        out_q: "queue.Queue" = queue.Queue()
        sent = [0]        # responses fully written (drain progress)
        in_send = [False]  # writer is inside sendall (vs device wait)

        def writer():
            while True:
                fut = out_q.get()
                if fut is None:
                    return
                try:
                    res = fut.result()
                    in_send[0] = True
                    _send_npy(conn, res)
                    in_send[0] = False
                    sent[0] += 1
                except Exception as e:
                    # includes BrokenPipeError when the client vanished
                    # mid-response: the batch still completes for other
                    # clients, only this connection dies
                    log(f"!! response failed: {type(e).__name__}: {e}")
                    try:
                        import socket as _s

                        conn.shutdown(_s.SHUT_RDWR)  # unblock the reader
                    except OSError:
                        pass
                    while True:  # drain; futures already resolve elsewhere
                        if out_q.get() is None:
                            return

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        try:
            while not stop.is_set():
                try:
                    arr = _recv_npy(conn)
                except ProtocolError as e:
                    # malformed header/payload (oversized length claim,
                    # non-npy bytes): drop THIS connection, keep serving
                    # — a bad client must not wedge or crash the daemon
                    log(f"!! protocol error: {e}")
                    return
                except OSError:
                    return  # writer shut the socket down
                if arr is None:
                    return
                if arr is STATS_REQUEST:
                    # health/stats op: answer in request order through the
                    # writer queue like any prediction (a pipelined client
                    # may interleave it mid-stream), as a JSON-bytes npy
                    fut: Future = Future()
                    fut.set_result(np.frombuffer(
                        _json_bytes(server.stats()), np.uint8))
                    out_q.put(fut)
                    continue
                try:
                    out_q.put(server.submit(arr))
                except Exception as e:
                    log(f"!! request failed: {type(e).__name__}: {e}")
                    return
        finally:
            out_q.put(None)
            # Drain every pending answer before closing: a pipelined
            # client half-closes after its last frame, and the first
            # result may take long on a cold daemon (its first forward).
            # Waiting on device work is unbounded by design; only a
            # writer stuck in sendall with zero progress for 30s (peer
            # stopped reading) is abandoned.
            while wt.is_alive() and not stop.is_set():
                before = sent[0]
                wt.join(timeout=DRAIN_NO_PROGRESS_TIMEOUT)
                if wt.is_alive() and in_send[0] and sent[0] == before:
                    break  # one send, nothing written for the whole
                    #        timeout: the peer stopped reading
            if wt.is_alive():
                # shutdown() breaks the send WITHOUT invalidating the fd
                # (close() under a concurrent sendall re-uses a dead fd
                # in CPython), then reap
                import socket as _s

                try:
                    conn.shutdown(_s.SHUT_RDWR)
                except OSError:
                    pass
                wt.join(timeout=5)
            conn.close()
            with conns_lock:
                conns.discard(conn)

    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            with conns_lock:
                conns.add(conn)
            threading.Thread(target=handle, args=(conn,), daemon=True).start()
    finally:
        srv.close()
        # unblock every reader parked in recv: without this a 'stopped'
        # server keeps serving its live connections and leaks their
        # daemon threads for process lifetime
        with conns_lock:
            live = list(conns)
        for c in live:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if cleanup is not None:
            cleanup()


def _connect(spec: str):
    """Client socket for a unix path or ``host:port`` spec."""
    import socket

    addr = parse_address(spec)
    if addr[0] == "tcp":
        # create_connection resolves the family (IPv4 AND IPv6 hosts)
        return socket.create_connection((addr[1], addr[2]))
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(addr[1])
    return c


def request(sock_path: str, rgb: np.ndarray) -> np.ndarray:
    """One client round trip (also the test/smoke client).  ``sock_path``
    may be a unix path or a ``host:port`` TCP spec."""
    c = _connect(sock_path)
    try:
        _send_npy(c, np.asarray(rgb))  # dtype must match the server's input_dtype
        out = _recv_npy(c)
        if out is None:
            raise ConnectionError("server closed the connection")
        return out
    finally:
        c.close()


def request_stream(sock_path: str, frames, depth: int = 32):
    """Pipelined client: keep up to ``depth`` requests in flight on one
    connection and yield predictions in frame order.  This is how a
    single client saturates the server's fixed device batch — the
    server's per-connection reader/writer split answers in order, so
    sending ahead is safe.  ``sock_path`` may be a unix path or a
    ``host:port`` TCP spec."""
    import socket
    import threading as _t

    c = _connect(sock_path)
    sem = _t.Semaphore(depth)
    dead = _t.Event()  # reader died / stream over: unblocks the sender
    n_sent = 0
    send_err = []

    def sender():
        nonlocal n_sent
        try:
            for f in frames:
                # timed acquire + dead-check: if the server stops
                # answering (clean EOF mid-stream), the window never
                # refills — a bare acquire() would block this thread
                # forever and the final join() with it
                while not sem.acquire(timeout=0.1):
                    if dead.is_set():
                        return
                if dead.is_set():
                    return
                _send_npy(c, np.asarray(f))
                n_sent += 1
        except Exception as e:  # surfaced by the reader on short stream
            send_err.append(e)
        finally:
            try:
                c.shutdown(socket.SHUT_WR)  # half-close: EOF after last
            except OSError:
                pass

    st = _t.Thread(target=sender, daemon=True)
    st.start()
    n_recv = 0
    try:
        while True:
            out = _recv_npy(c)
            if out is None:
                dead.set()
                st.join()
                if send_err:
                    raise send_err[0]
                if n_recv != n_sent:
                    raise ConnectionError(
                        f"server closed mid-stream ({n_recv}/{n_sent} answered)")
                return
            n_recv += 1
            sem.release()
            yield out
    finally:
        dead.set()
        st.join(timeout=5)
        if st.is_alive():
            # sender stuck in sendall (server stopped reading, buffer
            # full): shutdown() unblocks it without the fd-reuse hazard
            # of close() under a concurrent sendall, then reap
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            st.join(timeout=5)
        c.close()


#: Abandon a connection's drain only after a send makes zero progress
#: for this long (peer stopped reading).  Waiting on DEVICE work during
#: the drain is unbounded by design — a cold daemon's first forward is slow.
DRAIN_NO_PROGRESS_TIMEOUT = 30.0


class ProtocolError(ValueError):
    """Malformed wire request (bad length header or non-npy payload)."""


#: Wire-protocol stats/health op: a ZERO-length frame (4-byte header of
#: zeros, no payload).  No legitimate npy serialization is 0 bytes, so
#: existing clients are unaffected; the response is the same length-
#: prefixed framing around a uint8 npy of the server's stats() JSON
#: (the deploy-protocol observability analogue of the reference's
#: time_evaluator report, tx2_run_tvm.py:42-53).
STATS_REQUEST = object()


def _json_bytes(obj) -> bytes:
    import json

    return json.dumps(obj).encode("utf-8")


def request_stats(sock_path: str) -> dict:
    """Client side of the stats/health op: one zero-length frame ->
    the server's :meth:`InferenceServer.stats` dict (incl. the
    p50/p99 request-latency distribution)."""
    import json

    c = _connect(sock_path)
    try:
        c.sendall((0).to_bytes(4, "big"))
        out = _recv_npy(c)
        if out is None:
            raise ConnectionError("server closed the connection")
        return json.loads(np.asarray(out).tobytes().decode("utf-8"))
    finally:
        c.close()


# Upper bound on a framed payload.  The largest legitimate frame is a raw
# 480x640x3 float32 npy (~3.7 MB); 16 MiB leaves generous slack while a
# hostile 4-byte header can no longer pin a handler thread (and its
# receive buffers) on a multi-GB claim.
MAX_PAYLOAD = 16 * 1024 * 1024


def _send_npy(conn, arr: np.ndarray) -> None:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    payload = buf.getvalue()
    conn.sendall(len(payload).to_bytes(4, "big") + payload)


def _recv_npy(conn, max_payload: int = MAX_PAYLOAD):
    """One length-prefixed npy frame; None on clean EOF / torn stream,
    ProtocolError on hostile or corrupt framing."""
    import io

    head = _recv_exact(conn, 4)
    if head is None:
        return None
    n = int.from_bytes(head, "big")
    if n == 0:
        return STATS_REQUEST  # health/stats op (no npy is ever 0 bytes)
    if n > max_payload:
        raise ProtocolError(
            f"declared payload {n} bytes exceeds the {max_payload}-byte bound")
    body = _recv_exact(conn, n)
    if body is None:
        return None
    try:
        # never unpickle wire bytes — object-array payloads are refused
        return np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:
        raise ProtocolError(f"payload is not a loadable npy: {e}") from e


def _recv_exact(conn, n: int):
    chunks = []
    got = 0
    while got < n:
        b = conn.recv(n - got)
        if not b:
            return None
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)
