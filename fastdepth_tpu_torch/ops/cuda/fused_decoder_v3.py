"""K3: the fused decoder level as a persistent, double-buffered kernel,
hand-written for Hopper.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage_v3``,
which walked the batch in one grid step through its own two-slot DMA
pipeline.  K3 launches as many blocks as fit on the card at once; each
walks work items (an image group of ``block_batch``, a tile, a Cout
tile) through a two-slot ``cp.async`` ring, so the next item's halo and
skip tiles load while the current one computes.  Same function, operands
and layouts as K1 (``fused_decoder.py``).  The CUDA source is
``fastdepth_tpu_torch/csrc/fused_decoder_v3.cu``.

Dispatch: a CPU tensor takes the plain version (K1's,
:func:`fused_decoder_stage_reference`); a CUDA tensor launches K3 or
raises.  ``LAUNCHES`` counts the launches of K3 and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastdepth_tpu_torch.ops.cuda.fused_decoder import (
    check_stage,
    fused_decoder_stage_reference,
    launch_stage,
    use_plain_version,
)
from fastdepth_tpu_torch.ops.cuda.fused_decoder_hwbc import kernel_block_batch

LAUNCHES = 0


def fused_decoder_stage_v3(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                           pw_w: torch.Tensor, pw_b: torch.Tensor,
                           skip: Optional[torch.Tensor] = None, *,
                           block_batch: int = 1,
                           blocks: Optional[int] = None) -> torch.Tensor:
    """One fused decoder level, ``block_batch`` images per work item (1-8).

    ``blocks``: the persistent grid's size; by default as many blocks as
    fit on the card at once (a smaller grid makes each block walk more
    items).  Operands and result as
    :func:`fused_decoder.fused_decoder_stage`.  On the CPU this is the
    plain version; on a CUDA tensor it launches K3 or raises."""
    global LAUNCHES
    N = check_stage(x, dw_w, dw_b, pw_w, pw_b, skip, "K3")[0]
    B = kernel_block_batch(block_batch, N)
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if use_plain_version("K3", x):
        return fused_decoder_stage_reference(x, dw_w, dw_b, pw_w, pw_b, skip)
    out = launch_stage("fd_fused_decoder_stage_v3", "K3", x, dw_w, dw_b, pw_w, pw_b, skip,
                       extra=(B, blocks or 0))
    LAUNCHES += 1
    return out
