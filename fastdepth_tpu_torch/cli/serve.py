"""Serving CLI on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/serve.py``: a micro-batching depth-inference daemon.

It loads a checkpoint (native .npz or TRUSTED reference .pth.tar pickle),
prepares one fixed-batch forward on the card (on the flagship: the
decoder levels through K1, the head through K4), and answers
length-prefixed .npy frames over a unix socket or TCP — single frames in,
(H, W, 1) depth maps out, packed into device batches (engine/server.py).
The wire format is the JAX package's: either package's client talks to
either package's daemon.

    python -m fastdepth_tpu_torch.cli.serve --evaluate model_best.npz \\
        --socket /tmp/fastdepth.sock --batch-size 32 [--bf16] [--device cuda|cpu]

Client modes against a running daemon (no model load):

    python -m fastdepth_tpu_torch.cli.serve --socket /tmp/fastdepth.sock \\
        --ping path/to/rgb.npy [--stream N]
    python -m fastdepth_tpu_torch.cli.serve --socket /tmp/fastdepth.sock --stats

Over a mesh, ``--mesh-devices N`` (each packed batch's rows) and
``--mesh-spatial S`` (the image height; the MobileNet + NNConv family)
start ``N x S`` ranks on this host (``parallel.distributed.launch``, one
a device); rank 0 binds the socket and serves, the others follow its
batches (``engine/server.py``).  A SIGINT to this process stops rank 0,
which stops the others.

``--impl mixed --tuning tuning/h100.<model>.json`` serves each decoder
level on the kernel that won on the card (``engine/autotune.py``).
"""

from __future__ import annotations

import argparse
import functools
import signal
import threading

import torch

from fastdepth_tpu_torch.engine.aot import IMPLS, check_tuning_flags, strict_f32
from fastdepth_tpu_torch.parallel import distributed as D
from fastdepth_tpu_torch.parallel.mesh import check_cli_mesh, mesh_from_cli

# seconds a mesh daemon's collective may wait: rank 0 sends an idle
# heartbeat every engine.server.HEARTBEAT_S, so only a rank that is gone
# lets one wait this long
MESH_GROUP_TIMEOUT_S = 60.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FastDepth serving daemon (PyTorch/CUDA port)")
    p.add_argument("-e", "--evaluate", default=None, metavar="PATH",
                   help="checkpoint: native .npz or reference .pth[.tar] "
                        "(TRUSTED source only — full-module pickle)")
    p.add_argument("--socket", default="/tmp/fastdepth.sock",
                   help="unix socket path, or HOST:PORT for TCP "
                        "(remote clients; e.g. 0.0.0.0:7000)")
    p.add_argument("--batch-size", type=int, default=32,
                   help="fixed device batch; requests are packed into it")
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16; without it f32 is true f32 (TF32 off for "
                        "cuDNN's convolutions and for matmuls)")
    p.add_argument("--uint8", action="store_true",
                   help="accept raw uint8 [0,255] frames and normalize "
                        "(/255) on the device: 4x less socket+transfer traffic, "
                        "the JAX server's math (cast, then divide)")
    p.add_argument("--half-output", action="store_true",
                   help="return float16 predictions (half the response "
                        "payload; ~1 cm quantization at 10 m)")
    p.add_argument("--impl", default="auto", choices=IMPLS,
                   help="forward (engine/aot._pick_apply): auto = decoder levels "
                        "through K1 and the head through K4 when the architecture "
                        "allows and BN is folded; mixed = each level on its tuned "
                        "winner (--tuning)")
    p.add_argument("--tuning", default=None, metavar="JSON",
                   help="with --impl mixed: tuning record (tuning/*.json) "
                        "whose per-stage winners pick each decoder "
                        "stage's kernel (the reference runs its AutoTVM-"
                        "tuned artifact the same way)")
    p.add_argument("--chain", action="store_true",
                   help="single-stream latency mode: run each packed window of "
                        "up to --batch-size frames as sequential batch-1 forwards "
                        "on the server's stream, one wait per window")
    p.add_argument("--stats", action="store_true",
                   help="client mode: fetch the live stats/health JSON "
                        "from --socket (frames, occupancy, p50/p99 request "
                        "latency) and print it")
    p.add_argument("--mesh-spatial", type=int, default=None, metavar="S",
                   help="additionally shard image HEIGHT S-way (total ranks = "
                        "mesh-devices x S; S must divide the image height)")
    p.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="shard each packed batch over an N-rank data-parallel "
                        "mesh (params replicate; one rank a device)")
    p.add_argument("--image-size", type=int, nargs=2, default=(224, 224),
                   metavar=("H", "W"))
    p.add_argument("--ping", default=None, metavar="RGB_NPY",
                   help="client mode: send one frame to --socket and print "
                        "the prediction stats (no model load)")
    p.add_argument("--ping-out", default=None, metavar="PRED_NPY",
                   help="with --ping: also save the prediction (NCHW, like "
                        "the reference deploy runner)")
    p.add_argument("--stream", type=int, default=0, metavar="N",
                   help="with --ping: send the frame N times PIPELINED on "
                        "one connection (request_stream) and report client-"
                        "side fps — how a real client should feed the "
                        "server's device batch")
    p.add_argument("--stream-depth", type=int, default=64, metavar="D",
                   help="with --stream: max requests in flight")
    p.add_argument("--stats-every", type=float, default=30.0, metavar="SEC",
                   help="log served-frames/occupancy stats every SEC seconds "
                        "(0 disables)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the port's kernels; cpu runs their plain "
                        "PyTorch versions; on either, f32 is true f32 (TF32 off)")
    return p.parse_args(argv)


def main(argv=None, *, _ready=None, _stop=None):
    """``_ready``/``_stop`` are test hooks threaded into the accept loop
    so the daemon-launch path can be driven in-process (the public
    surface is unchanged: blocking loop, Ctrl-C to stop)."""
    args = parse_args(argv)

    import numpy as np

    from fastdepth_tpu_torch.engine.server import request

    if args.stats:
        import json

        from fastdepth_tpu_torch.engine.server import request_stats

        print(json.dumps(request_stats(args.socket), indent=1))
        return 0

    if args.ping:
        rgb = np.load(args.ping)
        if rgb.ndim == 3 and rgb.shape[0] == 3:  # CHW -> HWC
            rgb = np.transpose(rgb, (1, 2, 0))
        if rgb.dtype != np.uint8:  # uint8 passes through (uint8 servers)
            rgb = rgb.astype(np.float32)
        if args.stream:
            import time

            from fastdepth_tpu_torch.engine.server import request_stream

            t0 = time.perf_counter()
            n = 0
            for pred in request_stream(args.socket, (rgb,) * args.stream,
                                       depth=args.stream_depth):
                n += 1
            dt = time.perf_counter() - t0
            print(f"streamed {n} frames in {dt:.3f}s = {n / dt:.1f} fps "
                  f"(depth {args.stream_depth}); last pred "
                  f"mean={pred.mean():.4f}")
            if args.ping_out:  # save the last prediction, like --ping
                np.save(args.ping_out, np.transpose(pred[None], (0, 3, 1, 2)))
                print(f"=> saved {args.ping_out}")
            return 0
        pred = request(args.socket, rgb)
        print(f"pred shape={pred.shape} min={pred.min():.4f} "
              f"max={pred.max():.4f} mean={pred.mean():.4f}")
        if args.ping_out:
            np.save(args.ping_out, np.transpose(pred[None], (0, 3, 1, 2)))
            print(f"=> saved {args.ping_out}")
        return 0

    if not args.evaluate:
        raise SystemExit("--evaluate is required (or use --ping for client mode)")
    check_tuning_flags(args.impl, args.tuning)
    # the mesh flags' checks before any rank starts or any checkpoint loads
    check_cli_mesh(args.mesh_devices, args.mesh_spatial, image_height=args.image_size[0],
                   batch_size=args.batch_size)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")
    if D.mesh_world(args) is None:
        return _serve(args, ready=_ready, stop=_stop)
    # a spawned rank cannot set this process's events: _stop reaches rank
    # 0 as a SIGINT (launch), and ready is the socket file appearing
    one = D.mesh_world(args) == 1
    fn = functools.partial(_serve, ready=_ready, stop=_stop) if one else _serve
    return D.launch(fn, args, timeout=MESH_GROUP_TIMEOUT_S, stop=None if one else _stop)


def _serve(args, ready=None, stop=None):
    """One rank's daemon (the whole daemon without a mesh): load, build the
    server; rank 0 serves until ``stop`` (or a SIGINT, or a failed rank),
    the others follow it until it closes.  A failed mesh rank exits
    non-zero."""
    import numpy as np

    from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
    from fastdepth_tpu_torch.engine.server import (
        InferenceServer,
        parse_address,
        serve_tcp,
        serve_unix_socket,
    )

    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are
    mesh = mesh_from_cli(args.mesh_devices, args.mesh_spatial,
                         image_height=args.image_size[0], batch_size=args.batch_size)
    primary = D.is_primary()
    main_thread = threading.current_thread() is threading.main_thread()
    if mesh is not None and main_thread:
        # a terminal's Ctrl-C reaches every rank: rank 0 shuts the mesh
        # down, the followers wait for its stop header
        stop = stop or threading.Event()
        signal.signal(signal.SIGINT, (lambda *_: stop.set()) if primary else signal.SIG_IGN)
    if primary:
        print(f"=> loading model '{args.evaluate}'")
    params, model, _ = load_params_and_model(args.evaluate)
    server = InferenceServer(
        model, params,
        batch_size=args.batch_size,
        image_size=tuple(args.image_size),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        impl=args.impl,
        tuning=args.tuning,
        input_dtype=np.uint8 if args.uint8 else np.float32,
        output_dtype=np.float16 if args.half_output else np.float32,
        chain=args.chain,
        # the socket readers allocate a FRESH array per received frame
        # (np.load over the wire bytes) and never touch it after
        # submit() — the defensive copy would be pure overhead here
        copy_inputs=False,
        mesh=mesh,
        device=None if mesh is not None else args.device,
    )
    if not primary:
        server.close()  # follows rank 0's batches until its stop header
        if server.failed.is_set():
            raise SystemExit(f"serving mesh: {server.fatal_error}")
        return 0
    if mesh is not None:
        stop = stop or threading.Event()
        threading.Thread(target=lambda: (server.failed.wait(), stop.set()), daemon=True).start()
    if args.stats_every > 0:
        import time

        def stats_loop():
            last = 0
            while True:
                time.sleep(args.stats_every)
                s = server.stats()
                if s["frames"] != last:
                    last = s["frames"]
                    print(f"=> served {s['frames']} frames in {s['batches']} "
                          f"batches (occupancy {s['mean_occupancy']:.0%}, "
                          f"queued {s['queued']})", flush=True)

        threading.Thread(target=stats_loop, daemon=True).start()
    addr = parse_address(args.socket)
    try:
        if addr[0] == "tcp":
            serve_tcp(server, addr[1], addr[2], ready=ready, stop=stop)
        else:
            # socket-file cleanup belongs to serve_unix_socket alone: it
            # unlinks only a socket it BOUND — an unlink here would also
            # fire when startup was refused because a live daemon owns
            # the path, silently unreachable-ing that daemon
            serve_unix_socket(server, args.socket, ready=ready, stop=stop)
    except KeyboardInterrupt:
        print("\n=> shutting down")
    finally:
        server.close()
    if server.failed.is_set():
        raise SystemExit(f"serving mesh: a rank failed ({server.fatal_error}); "
                         "the daemon is down")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
