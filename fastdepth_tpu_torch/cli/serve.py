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

Not ported yet: ``--mesh-devices`` / ``--mesh-spatial`` (ROADMAP A12b) and
``--impl mixed`` / ``--tuning`` (ROADMAP A14); they are parsed under the
JAX names and refused.
"""

from __future__ import annotations

import argparse

import torch

from fastdepth_tpu_torch.engine.aot import IMPLS, strict_f32
from fastdepth_tpu_torch.engine.server import MESH_NOT_PORTED, TUNED_NOT_PORTED


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
    p.add_argument("--impl", default="auto", choices=[*IMPLS, "mixed"],
                   help="forward (engine/aot._pick_apply): auto = decoder levels "
                        "through K1 and the head through K4 when the architecture "
                        "allows and BN is folded; mixed is not ported yet (ROADMAP A14)")
    p.add_argument("--tuning", default=None, metavar="JSON",
                   help="with --impl mixed: a tuning record; not ported yet "
                        "(ROADMAP A14)")
    p.add_argument("--chain", action="store_true",
                   help="single-stream latency mode: run each packed window of "
                        "up to --batch-size frames as sequential batch-1 forwards "
                        "on the server's stream, one wait per window")
    p.add_argument("--stats", action="store_true",
                   help="client mode: fetch the live stats/health JSON "
                        "from --socket (frames, occupancy, p50/p99 request "
                        "latency) and print it")
    p.add_argument("--mesh-spatial", type=int, default=None, metavar="S",
                   help="shard image height S-way: not ported yet (ROADMAP A12b)")
    p.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="shard each packed batch over N devices: not ported yet "
                        "(ROADMAP A12b)")
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


def _refuse_unported(args) -> None:
    if args.mesh_devices is not None or args.mesh_spatial is not None:
        raise SystemExit(MESH_NOT_PORTED)
    if args.impl == "mixed" or args.tuning is not None:
        raise SystemExit(TUNED_NOT_PORTED)


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
    _refuse_unported(args)
    if not args.bf16:
        strict_f32()  # f32 is true f32; bf16 runs leave the flags as they are
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain PyTorch versions)")

    from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
    from fastdepth_tpu_torch.engine.server import (
        InferenceServer,
        parse_address,
        serve_tcp,
        serve_unix_socket,
    )

    print(f"=> loading model '{args.evaluate}'")
    params, model, _ = load_params_and_model(args.evaluate)
    server = InferenceServer(
        model, params,
        batch_size=args.batch_size,
        image_size=tuple(args.image_size),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        impl=args.impl,
        input_dtype=np.uint8 if args.uint8 else np.float32,
        output_dtype=np.float16 if args.half_output else np.float32,
        chain=args.chain,
        # the socket readers allocate a FRESH array per received frame
        # (np.load over the wire bytes) and never touch it after
        # submit() — the defensive copy would be pure overhead here
        copy_inputs=False,
        device=args.device,
    )
    if args.stats_every > 0:
        import threading
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
            serve_tcp(server, addr[1], addr[2], ready=_ready, stop=_stop)
        else:
            # socket-file cleanup belongs to serve_unix_socket alone: it
            # unlinks only a socket it BOUND — an unlink here would also
            # fire when startup was refused because a live daemon owns
            # the path, silently unreachable-ing that daemon
            serve_unix_socket(server, args.socket, ready=_ready, stop=_stop)
    except KeyboardInterrupt:
        print("\n=> shutting down")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
