"""K7: the epilogue of a folded inference conv, a hand-written Hopper kernel.

It replaces no Pallas kernel: on the TPU, XLA fused the bias and the
activation into each convolution.  On the card ATen runs cuDNN's conv,
then the bias as a broadcast ``add_`` that cannot vectorise, then the
activation (and a residual add) as further passes.  K7 does

    y <- act(round(round(y + b[c]) + residual))

in one pass over the conv's channels_last output, rounding to the working
dtype where ATen's sequence rounds, so that it is bit for bit that
sequence.  The CUDA source is ``fastdepth_tpu_torch/csrc/conv_epilogue.cu``
(its header states the byte bound and the design); it is built by
``_build`` at the first launch.  ``models/layers.apply_conv_bn`` routes a
conv through it where the conv's leaf is folded and the forward is for
inference.

Dispatch: K7 is the custom op ``fastdepth::conv_epilogue``
(``kernel.register``, at import, as K1's and K4's are): its CPU kernel is
:func:`conv_epilogue_reference`, its CUDA kernel launches K7 into a new
output or raises.  :func:`launch`, the entry ``apply_conv_bn`` calls,
checks the layout and calls :data:`EPILOGUE_OP`, the op's eager
dispatch: under a trace the op, in eager mode the implementation
directly, on CUDA writing ``y`` in place, inside the span
``fastdepth::conv_epilogue``.
:func:`conv_epilogue` checks every operand first.  Its launches count
under "K7" in ``kernel.COUNTER``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fastdepth_tpu_torch.ops.cuda import kernel

# the activation after the epilogue's sums: K7's codes
NONE, RELU, RELU6 = 0, 1, 2


def conv_epilogue_reference(y: torch.Tensor, b: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            act: int = NONE) -> torch.Tensor:
    """Plain PyTorch version of K7 (same arguments), ATen's unfused
    sequence: the broadcast bias add, ``+ residual``, then ``relu`` or
    ``clamp(0, 6)``, each op rounding to ``y``'s dtype.  Returns a new
    tensor; ``y`` is not written."""
    y = y + b.reshape(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    if act == RELU:
        return torch.relu(y)
    if act == RELU6:
        return torch.clamp(y, 0, 6)
    return y


def conv_epilogue(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  act: int = NONE) -> torch.Tensor:
    """The epilogue of a conv whose output ``y`` ``(N, C, H, W)`` was
    computed without its bias ``b`` ``(C,)``: adds ``b``, then
    ``residual`` (``y``'s shape) where given, then applies ``act``
    (:data:`NONE`, :data:`RELU` or :data:`RELU6`).  ``y`` and
    ``residual`` channels_last, one dtype (f32 or bf16) for all.  On a
    CUDA tensor it launches K7, which writes ``y`` in place and returns
    it; on the CPU it returns the plain version's new tensor."""
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    if tuple(b.shape) != (y.shape[1],):
        raise ValueError(f"b must be ({y.shape[1]},), got {tuple(b.shape)}")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"residual must be {tuple(y.shape)}, got {tuple(residual.shape)}")
    if act not in (NONE, RELU, RELU6):
        raise ValueError(f"act must be NONE, RELU or RELU6, got {act!r}")
    kernel.check_operands("K7", {"y": y, "residual": residual}, {"b": b})
    return launch(y, b, residual, act)


def launch(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor],
           act: int) -> torch.Tensor:
    """:func:`conv_epilogue` for ``models/layers.apply_conv_bn``, whose
    routing has checked the dtypes, the devices and the gradients: checks
    only that ``y`` and ``residual`` are channels_last (the ops' stated
    layout; a trace's strides are FakeTensor's guess, which the op's CUDA
    kernel checks at the run), then K7 in place on CUDA, the plain
    version on the CPU (``kernel.Op``).  K7 runs once a conv, so the
    layout is read directly, and ``kernel.check_layout`` names the
    operand only where it fails."""
    if not (y.is_contiguous(memory_format=torch.channels_last) and (
            residual is None or residual.is_contiguous(memory_format=torch.channels_last))
            or torch.compiler.is_compiling()):
        kernel.check_layout({"y": y, "residual": residual})
    return EPILOGUE_OP(y, b, residual, act)


def _epilogue_cpu(y, b, residual, act):
    """``fastdepth::conv_epilogue`` on the CPU: the plain version."""
    return conv_epilogue_reference(y, b, residual, act)


def _epilogue_cuda(y, b, residual, act):
    """``fastdepth::conv_epilogue`` on CUDA: K7 into a new output, so the
    op writes none of its inputs.  The layout is checked again here,
    where a saved program's run reaches the kernel without the wrapper."""
    kernel.check_layout({"y": y, "residual": residual})
    return _run(y, b, residual, act, _epilogue_fake(y, b, residual, act))


# fd_conv_epilogue(y, out, b, residual, pixels, C, act, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _run(y, b, residual, act, out=None):
    """One launch of K7 from ``y`` into ``out`` (by default ``y``
    itself, in place: the eager call's CUDA implementation); the caller
    checked the operands."""
    out = y if out is None else out
    N, C, H, W = y.shape
    kernel.launch("K7", "fd_conv_epilogue", _ARGTYPES, (y, out, b, residual), N * H * W, C, act,
                  kernel.DTYPES[y.dtype])
    return out


def _epilogue_fake(y, b, residual, act):
    """The output the op writes: ``y``'s shape, dtype and layout."""
    return torch.empty_like(y, memory_format=torch.channels_last)


EPILOGUE_OP = kernel.register(
    "K7", "conv_epilogue(Tensor y, Tensor b, Tensor? residual, int act) -> Tensor",
    _epilogue_cpu, _epilogue_cuda, _epilogue_fake, eager=_run)
