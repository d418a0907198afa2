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

Dispatch: K7 is the custom op ``fastdepth::conv_epilogue``, registered
at import as K1's and K4's are: its CPU kernel is
:func:`conv_epilogue_reference`, its CUDA kernel launches K7 into a new
output or raises.  :func:`conv_epilogue` checks the operands, calls the op
under a trace, and in eager mode runs the implementation directly, on
CUDA writing ``y`` in place, inside the span ``fastdepth::conv_epilogue``
(``engine/profiler.K7``).  :func:`launch` is the same call for
``apply_conv_bn``, which has already checked what it routes: it checks
only the layout.  ``LAUNCHES`` counts the launches of K7 and nothing
else, in the Python that makes them: a replay of
``engine/aot.compile_forward``'s CUDA graph runs its K7 launches without
it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fastdepth_tpu_torch.engine.profiler import K7 as K7_SPAN
from fastdepth_tpu_torch.engine.profiler import annotate
from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda.fused_decoder import DTYPES, check_layout, use_plain_version

LAUNCHES = 0

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
    _check(y, b, residual)
    if torch.compiler.is_compiling():
        return EPILOGUE_OP(y, b, residual, act)
    cpu = not y.is_cuda and use_plain_version("K7", y)
    with annotate(K7_SPAN):
        return _epilogue_cpu(y, b, residual, act) if cpu else _launch(y, b, residual, act, y)


def launch(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor],
           act: int) -> torch.Tensor:
    """:func:`conv_epilogue` for ``models/layers.apply_conv_bn``, whose
    routing has checked the dtypes, the devices and the gradients: checks
    only that ``y`` and ``residual`` are channels_last (the ops' stated
    layout; raises otherwise), then K7 in place on CUDA, the plain version
    on the CPU."""
    if torch.compiler.is_compiling():
        return EPILOGUE_OP(y, b, residual, act)
    if not y.is_contiguous(memory_format=torch.channels_last) or (
            residual is not None and not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("K7 reads channels_last (NHWC) activations: y "
                         f"{tuple(y.stride())}, residual "
                         f"{None if residual is None else tuple(residual.stride())}")
    with annotate(K7_SPAN):
        return _launch(y, b, residual, act, y) if y.is_cuda else _epilogue_cpu(
            y, b, residual, act)


def _check(y, b, residual):
    """``fused_decoder.check_operands``'s checks, written out for the
    three operands (K7 runs once a conv, so its host time counts): one
    dtype (f32 or bf16) and one device, channels_last activations (a
    trace's strides are FakeTensor's guess: the CUDA kernel checks the
    run's), a contiguous bias, no gradient."""
    acts = (y,) if residual is None else (y, residual)
    if y.dtype not in DTYPES or any(t.dtype != y.dtype for t in (b, *acts)):
        raise ValueError("K7 takes float32 or bfloat16, one dtype for every operand; got "
                         + ", ".join(str(t.dtype) for t in (*acts, b)))
    if b.device != y.device or (residual is not None and residual.device != y.device):
        raise ValueError("K7's operands must lie on one device")
    if not torch.compiler.is_compiling():
        check_layout({"y": y, "residual": residual})
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (b, *acts)):
        raise ValueError("K7 is inference-only: it has no backward")


def _epilogue_cpu(y, b, residual, act):
    """``fastdepth::conv_epilogue`` on the CPU: the plain version."""
    return conv_epilogue_reference(y, b, residual, act)


def _epilogue_cuda(y, b, residual, act):
    """``fastdepth::conv_epilogue`` on CUDA: K7 into a new output, so the
    op writes none of its inputs.  The layout is checked again here,
    where a saved program's run reaches the kernel without the wrapper."""
    check_layout({"y": y, "residual": residual})
    return _launch(y, b, residual, act, _epilogue_fake(y, b, residual, act))


# fd_conv_epilogue(y, out, b, residual, pixels, C, act, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _launch(y, b, residual, act, out):
    """One launch of K7 from ``y`` into ``out`` (``y`` itself in place) on
    the current stream of ``y``'s device; the caller checked the
    operands.  K7 runs once a conv, so the launch keeps its host time
    short: the device is switched only where it is not already current,
    and the stream is read as the raw handle (``torch.cuda.
    current_stream(...).cuda_stream`` builds a Stream object: 7 us a
    call on the card's host, against 0.2)."""
    global LAUNCHES
    dev = y.get_device()
    if dev != torch._C._cuda_getDevice():  # torch.cuda.current_device() less its lazy init
        with torch.cuda.device(dev):
            return _launch(y, b, residual, act, out)
    N, C, H, W = y.shape
    fn = _build.function("fd_conv_epilogue", _ARGTYPES)
    err = fn(y.data_ptr(), out.data_ptr(), b.data_ptr(),
             residual.data_ptr() if residual is not None else None,
             N * H * W, C, act, DTYPES[y.dtype], torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _epilogue_fake(y, b, residual, act):
    """The output the op writes: ``y``'s shape, dtype and layout."""
    return torch.empty_like(y, memory_format=torch.channels_last)


# K7 as the custom op fastdepth::conv_epilogue, registered as K1's is
# (ops/cuda/fused_decoder.py): the plain version on the CPU, K7 on CUDA,
# a fake for torch.export's trace, no autograd.
LIBRARY = torch.library.Library("fastdepth", "FRAGMENT")
LIBRARY.define("conv_epilogue(Tensor y, Tensor b, Tensor? residual, int act) -> Tensor")
LIBRARY.impl("conv_epilogue", _epilogue_cpu, "CPU")
LIBRARY.impl("conv_epilogue", _epilogue_cuda, "CUDA")
torch.library.register_fake("fastdepth::conv_epilogue", _epilogue_fake, lib=LIBRARY)
EPILOGUE_OP = torch.ops.fastdepth.conv_epilogue.default
