"""K4: the FastDepth 1x1 head, a hand-written Hopper kernel.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_pointwise_head``: per
pixel, a C -> 1 dot product + bias -> ReLU, accumulated in f32.  The
CUDA source is ``fastdepth_tpu_torch/csrc/pointwise_head.cu``.

Dispatch: a CPU tensor takes :func:`pointwise_head_reference`; a CUDA
tensor launches K4 or raises.  ``LAUNCHES`` counts the launches of K4 and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda.fused_decoder import (
    DTYPES,
    check_operands,
    use_plain_version,
)

LAUNCHES = 0


def pointwise_head_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (same arguments): a 1x1 conv + bias +
    ReLU in f32 (f64 stays f64), cast back to ``x``'s dtype."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(f32), w.to(f32).reshape(1, -1, 1, 1), b.to(f32))
    return torch.relu(y).to(x.dtype).contiguous(memory_format=torch.channels_last)


def pointwise_head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The head on x ``(N, C, H, W)`` channels_last with w ``(C,)`` and b
    ``(1,)``: returns ``(N, 1, H, W)`` in ``x``'s dtype.  On the CPU this
    is the plain version; on a CUDA tensor it launches K4 or raises."""
    global LAUNCHES
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    N, C, H, W = x.shape
    for name, t, shape in (("w", w, (C,)), ("b", b, (1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    check_operands("K4", {"x": x}, {"w": w, "b": b})
    if use_plain_version("K4", x):
        return pointwise_head_reference(x, w, b)
    out = torch.empty((N, 1, H, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    fn = _build.function("fd_pointwise_head", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                        N * H * W, C, DTYPES[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
