"""Autotune runner on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/autotune.py``: per-op tuning records for the released
model family on the attached card, the breadth of the reference's AutoTVM
tuning DB (reference tvm_compile/tuning/: 8 logs = 4 models x 2 targets,
every conv task; README.md:69).

    python -m fastdepth_tpu_torch.cli.autotune [--models all] [--out tuning/] [--device cuda|cpu]

Writes ``<out>/<tag>.<model>.json`` (the tag from the card's name:
``h100`` on an H100, ``engine/autotune.device_tag``) with every encoder
conv op and every decoder stage timed per dtype: the plain cuDNN stage
('xla') always, K1 ('pallas') besides for dw5x5 decoders.
``models/fused.apply_fastdepth_mixed`` runs the winner map
(``engine/autotune.load_tuning``).  ``--device cpu`` times the plain
versions on the CPU (CPU times, for the record's shape only).
"""

from __future__ import annotations

import argparse
import os

import torch

# The 4 released depth models (reference README download table / tuning
# log names).
MODEL_CONFIGS = {
    "mobilenet-nnconv5": dict(decoder="nnconv5", skip=None),
    "mobilenet-nnconv5dw": dict(decoder="nnconv5dw", skip=None),
    "mobilenet-nnconv5dw-skipadd": dict(decoder="nnconv5dw", skip="add"),
    "mobilenet-nnconv5dw-skipadd-pruned": "pruned",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-op kernel tuning records (PyTorch/CUDA port)")
    p.add_argument("--models", default="all",
                   help="comma list or 'all': " + ",".join(MODEL_CONFIGS))
    p.add_argument("--out", default="tuning")
    p.add_argument("--batch-enc", type=int, default=32)
    p.add_argument("--batch-dec", type=int, default=4)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--no-pallas", action="store_true",
                   help="skip K1, the Pallas stage's counterpart ('xla'-only records)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda times the card; cpu the plain versions on the CPU")
    return p.parse_args(argv)


def config_for(name: str):
    from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED, ModelConfig

    spec = MODEL_CONFIGS[name]
    if spec == "pruned":
        return FASTDEPTH_PRUNED
    return ModelConfig(**spec)


def main(argv=None):
    args = parse_args(argv)

    from fastdepth_tpu_torch.engine.autotune import _device_kind, device_tag, tune_model

    names = (list(MODEL_CONFIGS) if args.models == "all"
             else [m.strip() for m in args.models.split(",")])
    unknown = [n for n in names if n not in MODEL_CONFIGS]
    if unknown:  # fail BEFORE any (minutes-long) tuning runs
        raise SystemExit(
            f"unknown model(s) {unknown}; valid: {sorted(MODEL_CONFIGS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to time the plain PyTorch versions)")
    dtypes = tuple(d.strip() for d in args.dtypes.split(","))
    tag = device_tag(_device_kind(args.device))
    written = []
    for name in names:
        cfg = config_for(name)
        out_path = os.path.join(args.out, f"{tag}.{name}.json")
        print(f"=> tuning {name} -> {out_path}", flush=True)
        tune_model(
            cfg,
            batch_enc=args.batch_enc, batch_dec=args.batch_dec,
            dtypes=dtypes, calls=args.calls,
            out_path=out_path,
            with_pallas=not args.no_pallas,
            device=args.device,
        )
        written.append(out_path)
        print(f"   done {name}", flush=True)
    print("records:", *written, sep="\n  ")
    return written


if __name__ == "__main__":
    main()
