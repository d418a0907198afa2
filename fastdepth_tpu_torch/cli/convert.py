"""Offline checkpoint converter CLI — reference PyTorch pickle -> npz
checkpoint; counterpart of ``fastdepth_tpu/cli/convert.py``, over the
port's own ``checkpoint/convert.py`` and ``checkpoint/io.py`` (the same
npz, which either package loads).

Usage:
    python -m fastdepth_tpu_torch.cli.convert model_best.pth.tar out.npz

The npz then runs on the card through the other CLIs (``cli.evaluate
--evaluate out.npz``, ``cli.deploy --model out.npz``, ``cli.serve
--evaluate out.npz``) for every model family of the registry: the
reference's MobileNet, ResNet and decoder classes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="torch checkpoint -> fastdepth .npz")
    p.add_argument("input",
                   help="reference .pth[.tar] checkpoint (full-module pickle; "
                        "unpickling executes code — TRUSTED sources only)")
    p.add_argument("output", help="output .npz path")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from fastdepth_tpu_torch.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu_torch.checkpoint.io import save_checkpoint

    params, cfg, meta = convert_checkpoint(args.input)
    best = {k[len("best_"):]: v for k, v in meta.items() if k.startswith("best_")}
    save_checkpoint(
        args.output, params, cfg,
        epoch=meta.get("epoch", 0),
        best_result=best or None,
        extra={"source_class": meta.get("source_class"), "source": args.input},
    )
    if not args.quiet:
        print(f"=> {args.input} ({meta.get('source_class')}) -> {args.output}")
        print(f"=> config: {json.dumps(dataclasses.asdict(cfg))}")
    return cfg


if __name__ == "__main__":
    main()
