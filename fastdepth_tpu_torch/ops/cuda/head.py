"""K4: the FastDepth 1x1 head, a hand-written Hopper kernel.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_pointwise_head``: per
pixel, a C -> 1 dot product + bias -> ReLU, accumulated in f32.  The
CUDA source is ``fastdepth_tpu_torch/csrc/pointwise_head.cu``.

Dispatch: K4 is the custom op ``fastdepth::pointwise_head``
(registered at import, as K1's op is): its CPU kernel is
:func:`pointwise_head_reference`, its CUDA kernel launches K4 or raises.
:func:`pointwise_head` checks the operands, then calls the op under a
trace and its implementation directly in eager mode.  ``LAUNCHES``
counts the launches of K4 and nothing else, in the Python that makes
them: a replay of ``engine/aot.compile_forward``'s CUDA graph runs its
K4 launch without it, so a count through that forward is the capture's
launches plus ``engine.aot.GRAPH_REPLAYS``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda.fused_decoder import (
    DTYPES,
    check_layout,
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
    is the plain version; on a CUDA tensor it launches K4 or raises.  The
    operands are checked here; a trace records the custom op
    ``fastdepth::pointwise_head`` (:data:`HEAD_OP`), an eager call runs
    its implementation directly, as K1's wrapper does."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    for name, t, shape in (("w", w, (C,)), ("b", b, (1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    check_operands("K4", {"x": x}, {"w": w, "b": b})
    if torch.compiler.is_compiling():
        return HEAD_OP(x, w, b)
    return (_head_cpu if use_plain_version("K4", x) else _head_cuda)(x, w, b)


def _head_cpu(x, w, b):
    """``fastdepth::pointwise_head`` on the CPU: the plain version."""
    return pointwise_head_reference(x, w, b)


def _head_cuda(x, w, b):
    """``fastdepth::pointwise_head`` on CUDA: one launch of K4 (the caller
    checked the operands; the layout again here, as K1's does)."""
    global LAUNCHES
    check_layout({"x": x})
    N, C, H, W = x.shape
    out = _head_fake(x, w, b)
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


def _head_fake(x, w, b):
    """The output K4 writes: ``(N, 1, H, W)`` channels_last."""
    N, _, H, W = x.shape
    return torch.empty((N, 1, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


# K4 as the custom op fastdepth::pointwise_head, registered as K1's is
# (ops/cuda/fused_decoder.py): the plain version on the CPU, K4 on CUDA,
# a fake for torch.export's trace, no autograd.
LIBRARY = torch.library.Library("fastdepth", "FRAGMENT")
LIBRARY.define("pointwise_head(Tensor x, Tensor w, Tensor b) -> Tensor")
LIBRARY.impl("pointwise_head", _head_cpu, "CPU")
LIBRARY.impl("pointwise_head", _head_cuda, "CUDA")
torch.library.register_fake("fastdepth::pointwise_head", _head_fake, lib=LIBRARY)
HEAD_OP = torch.ops.fastdepth.pointwise_head.default
