"""K4: the FastDepth 1x1 head, a hand-written Hopper kernel.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_pointwise_head``: per
pixel, a C -> 1 dot product + bias -> ReLU, accumulated in f32.  The
CUDA source is ``fastdepth_tpu_torch/csrc/pointwise_head.cu``.

Dispatch: K4 is the custom op ``fastdepth::pointwise_head``
(``kernel.register``, at import, as K1's op is): its CPU kernel is
:func:`pointwise_head_reference`, its CUDA kernel launches K4 or raises.
:func:`pointwise_head` checks the operands, then calls :data:`HEAD_OP`,
the op's eager dispatch; its launches count under "K4" in
``kernel.COUNTER``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import kernel

# fd_pointwise_head(x, w, b, out, pixels, C, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


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
    its implementation directly inside the op's span (``kernel.Op``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    for name, t, shape in (("w", w, (C,)), ("b", b, (1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    kernel.check_operands("K4", {"x": x}, {"w": w, "b": b})
    return HEAD_OP(x, w, b)


def _head_cpu(x, w, b):
    """``fastdepth::pointwise_head`` on the CPU: the plain version."""
    return pointwise_head_reference(x, w, b)


def _head_cuda(x, w, b):
    """``fastdepth::pointwise_head`` on CUDA: one launch of K4 (the caller
    checked the operands; the layout again here, as K1's does)."""
    kernel.check_layout({"x": x})
    N, C, H, W = x.shape
    out = _head_fake(x, w, b)
    kernel.launch("K4", "fd_pointwise_head", _ARGTYPES, (x, w, b, out), N * H * W, C,
                  kernel.DTYPES[x.dtype])
    return out


def _head_fake(x, w, b):
    """The output K4 writes: ``(N, 1, H, W)`` channels_last."""
    N, _, H, W = x.shape
    return torch.empty((N, 1, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


HEAD_OP = kernel.register("K4", "pointwise_head(Tensor x, Tensor w, Tensor b) -> Tensor",
                          _head_cpu, _head_cuda, _head_fake)
