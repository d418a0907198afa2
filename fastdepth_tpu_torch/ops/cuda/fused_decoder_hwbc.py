"""K2: the fused decoder level over image groups, a hand-written Hopper kernel.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage_hwbc``.
It computes K1's function (``fused_decoder.py``) with K1's operands and
layouts; what it keeps from the TPU kernel is ``block_batch``: a block
holds the same tile of that many images, so each chunk of weights it
loads serves all of them, and the pointwise product is one tile GEMM
over the group's pixels.  The TPU kernel's (N/B, H, W, B, C) view existed
only for Mosaic's tiling and has no counterpart here: K2 reads and writes
channels_last like K1.  The CUDA source is
``fastdepth_tpu_torch/csrc/fused_decoder_hwbc.cu``; its block is K1's
(``csrc/stage_tile.cuh``), and :func:`launch_geometry` picks the launch
in closed form, K1's rules over image groups.

Dispatch: a CPU tensor takes the plain version (K1's,
:func:`fused_decoder_stage_reference`); a CUDA tensor launches K2 or
raises.  ``LAUNCHES`` counts the launches of K2 and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
from fastdepth_tpu_torch.ops.cuda.fused_decoder import (
    Geometry,
    check_stage,
    fused_decoder_stage_reference,
    launch_stage,
    use_plain_version,
)

LAUNCHES = 0

MAX_BLOCK_BATCH = 8  # the kernels take image groups of 1, 2, 4 or 8


def kernel_block_batch(block_batch: int, n: int) -> int:
    """The images per block a kernel of the family runs for ``block_batch``
    at batch ``n``: at most ``n``, rounded up to a power of two (the images
    past ``n`` are masked, so the result never depends on it)."""
    if not 1 <= block_batch <= MAX_BLOCK_BATCH:
        raise ValueError(f"block_batch must be 1 to {MAX_BLOCK_BATCH}, got {block_batch}")
    b = min(block_batch, max(n, 1))
    return 1 << (b - 1).bit_length()


def launch_geometry(N: int, H: int, W: int, C: int, Cout: int, dtype: torch.dtype,
                    block_batch: int) -> Geometry:
    """K2's launch for one level at ``block_batch`` images per block
    (rounded by :func:`kernel_block_batch`), in closed form: K1's rules
    (``fused_decoder.launch_geometry``) with the tile GEMM's rows an image
    group's pixel tiles.  Where image groups x tiles leave SMs idle it
    shrinks the per-image tile (down to 4 pixels), then splits C over
    thread groups, and only last splits Cout."""
    return K1.launch_geometry(N, H, W, C, Cout, dtype, images=kernel_block_batch(block_batch, N))


def launch_args(g: Geometry):
    """The geometry as the C entries of K2 and K3 take it."""
    return (g.threads, g.tile_h, g.tile_w, g.cout_tile, g.chunk, g.groups, g.images)


def fused_decoder_stage_hwbc(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                             pw_w: torch.Tensor, pw_b: torch.Tensor,
                             skip: Optional[torch.Tensor] = None, *,
                             block_batch: int = 8) -> torch.Tensor:
    """One fused decoder level, ``block_batch`` images per block (1-8).

    Operands and result as :func:`fused_decoder.fused_decoder_stage`.  On
    the CPU this is the plain version; on a CUDA tensor it launches K2 or
    raises."""
    global LAUNCHES
    N, C, H, W, Cout = check_stage(x, dw_w, dw_b, pw_w, pw_b, skip, "K2")
    kernel_block_batch(block_batch, N)
    if use_plain_version("K2", x):
        return fused_decoder_stage_reference(x, dw_w, dw_b, pw_w, pw_b, skip)
    g = launch_geometry(N, H, W, C, Cout, x.dtype, block_batch)
    if g.grid[0] >= 2 ** 31 or g.grid[1] > 65535:
        raise ValueError(f"K2's grid {g.grid} is too large for one launch")
    out = launch_stage("fd_fused_decoder_stage_hwbc", "K2", x, dw_w, dw_b, pw_w, pw_b, skip,
                       extra=launch_args(g))
    LAUNCHES += 1
    return out
