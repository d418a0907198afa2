"""Golden-array visualizer on the PyTorch/CUDA port — counterpart of
``fastdepth_tpu/cli/visualize.py`` and of reference
deploy/data/visualize.py:9-35: renders rgb/depth/pred .npy files to PNGs
with the viridis colormap (the port's ``viz.py``).

Usage:
    python -m fastdepth_tpu_torch.cli.visualize --rgb rgb.npy --depth depth.npy \\
        --pred pred.npy [--out-dir .]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fastdepth_tpu_torch import viz


def main(argv=None):
    p = argparse.ArgumentParser(description="npy -> PNG depth visualizer (PyTorch/CUDA port)")
    p.add_argument("--rgb", default=None)
    p.add_argument("--depth", default=None)
    p.add_argument("--pred", default=None)
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.rgb:
        rgb = np.squeeze(np.load(args.rgb))
        if rgb.ndim == 3 and rgb.shape[0] == 3:
            rgb = np.transpose(rgb, (1, 2, 0))
        viz.save_image(255 * rgb if rgb.max() <= 1.0 else rgb,
                       os.path.join(args.out_dir, "rgb.png"))
    for name, path in (("depth", args.depth), ("pred", args.pred)):
        if path:
            d = np.squeeze(np.load(path))
            viz.save_image(viz.colored_depthmap(d),
                           os.path.join(args.out_dir, f"{name}.png"))
    print(f"=> wrote PNGs to {args.out_dir}")


if __name__ == "__main__":
    main()
