"""K3: the fused decoder level as a persistent, double-buffered kernel,
hand-written for Hopper.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage_v3``,
which walked the batch in one grid step through its own two-slot DMA
pipeline.  K3 launches as many blocks as the card holds at once; each
walks work items (an image group of ``block_batch``, a K1-sized pixel
tile of each image, all of Cout <= 256) in stride order through K1's
two-slot ``cp.async`` chunk ring, which runs across item boundaries, so
the next item's first chunk loads while the current one's last
computes.  Same function, operands and layouts as K1
(``fused_decoder.py``).  The CUDA source is
``fastdepth_tpu_torch/csrc/fused_decoder_v3.cu``; its block is K1's
(``csrc/stage_tile.cuh``).

Dispatch: a CPU tensor takes the plain version (K1's,
:func:`fused_decoder_stage_reference`); a CUDA tensor launches K3 or
raises.  ``LAUNCHES`` counts the launches of K3 and nothing else.
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
from fastdepth_tpu_torch.ops.cuda.fused_decoder_hwbc import kernel_block_batch, launch_args

LAUNCHES = 0


def launch_geometry(N: int, H: int, W: int, C: int, Cout: int, dtype: torch.dtype,
                    block_batch: int) -> Geometry:
    """K3's launch for one level, in closed form: K2's geometry
    (``fused_decoder_hwbc.launch_geometry``) with the epilogue's staging
    beside the pipeline's buffers in shared memory.  Its ``grid`` counts
    the work items; the persistent grid is :func:`resident_blocks`."""
    return K1.launch_geometry(N, H, W, C, Cout, dtype, images=kernel_block_batch(block_batch, N),
                              persistent=True)


def resident_blocks(g: Geometry) -> int:
    """The blocks the card holds at once for launch ``g``: the SMs times
    the blocks an SM holds, by registers and shared memory."""
    return K1.SMS * g.per_sm


def fused_decoder_stage_v3(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                           pw_w: torch.Tensor, pw_b: torch.Tensor,
                           skip: Optional[torch.Tensor] = None, *,
                           block_batch: int = 1,
                           blocks: Optional[int] = None) -> torch.Tensor:
    """One fused decoder level, ``block_batch`` images per work item (1-8).

    ``blocks``: the persistent grid's size; by default as many blocks as
    the card holds at once (:func:`resident_blocks`; a smaller grid makes
    each block walk more items).  Operands and result as
    :func:`fused_decoder.fused_decoder_stage`.  On the CPU this is the
    plain version; on a CUDA tensor it launches K3 or raises."""
    global LAUNCHES
    N, C, H, W, Cout = check_stage(x, dw_w, dw_b, pw_w, pw_b, skip, "K3")
    kernel_block_batch(block_batch, N)
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if use_plain_version("K3", x):
        return fused_decoder_stage_reference(x, dw_w, dw_b, pw_w, pw_b, skip)
    g = launch_geometry(N, H, W, C, Cout, x.dtype, block_batch)
    if g.blocks >= 2 ** 31:
        raise ValueError(f"K3's {g.blocks} work items are too many for one launch")
    out = launch_stage("fd_fused_decoder_stage_v3", "K3", x, dw_w, dw_b, pw_w, pw_b, skip,
                       extra=(*launch_args(g), blocks or resident_blocks(g)))
    LAUNCHES += 1
    return out
