"""How Python calls the port's hand-written kernels (K1-K8).

Each kernel's wrapper module holds what is its own: the shapes it takes,
its launch geometry, its plain PyTorch version and, for a custom op, the
fake that gives a trace its output's metadata.  What they share is here:

* :func:`check_operands` and :func:`check_layout`, the checks every
  wrapper makes (one dtype of :data:`DTYPES`, one device, channels_last
  activations, contiguous weights, no gradient);
* :func:`use_plain_version`, the device rule: a CPU tensor takes the
  plain version, a CUDA tensor the kernel, any other device raises;
* :func:`launch`, the one launch: the C entry (``_build.function``) on
  the current stream of the operands' device, its error code checked,
  the launch counted in :data:`COUNTER` under the kernel's label;
* :func:`register`, which makes a kernel the custom op
  ``fastdepth::<name>`` (the plain version on the CPU, the kernel on
  CUDA, a fake for ``torch.export``'s trace, no autograd), so that a
  trace records one node (``engine/aot.save_bundle``), and returns it as
  an :class:`Op`, whose call is the eager dispatch: under a trace the
  op; otherwise the implementation for the device, called directly,
  without the dispatcher's host time, inside a profiler span of the
  op's name (``engine/profiler``).

:data:`COUNTER` counts launches by label ("K1" ... "K8") in the Python
that makes them: a replay of ``engine/aot.compile_forward``'s CUDA graph
runs its launches without it, so a count through that forward is the
capture's launches plus ``engine.aot.GRAPH_REPLAYS`` times the forward's.

Adding a kernel takes its ``.cu`` source under ``csrc/`` (``_build``
compiles it with the others at the first launch), a wrapper module with
its shapes, plain version and (for an op) fake that calls :func:`launch`,
and, for an op, one :func:`register` call, whose :class:`Op` the wrapper
calls.

Nothing here builds or loads CUDA code at import time.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from fastdepth_tpu_torch.ops.cuda import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes

SMS = 132  # an H100 SXM's streaming multiprocessors
MAX_SMEM = 232448  # the most shared memory a Hopper block may have (227 KB)
SMEM_PER_SM = 233472  # 228 KB an SM

COUNTER: collections.Counter = collections.Counter()

# the fastdepth namespace's registrations go with this object: it must
# stay referenced
_LIBRARY = torch.library.Library("fastdepth", "FRAGMENT")


def check_operands(label, activations, weights):
    """The checks every kernel wrapper makes: one dtype (f32 or bf16) and
    one device for all operands, channels_last activations, contiguous
    weights, no gradient.  ``None`` operands are skipped."""
    tensors = [t for t in (*activations.values(), *weights.values()) if t is not None]
    dtype = tensors[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            f"{label} takes float32 or bfloat16, one dtype for every operand; got "
            + ", ".join(str(t.dtype) for t in tensors))
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{label}'s operands must lie on one device")
    if not torch.compiler.is_compiling():
        # a trace's strides are FakeTensor's guess, which for cuDNN's
        # convolutions is not always the card's choice: the op's CUDA
        # kernel checks the layout the run gives (check_layout)
        check_layout(activations)
    for name, t in weights.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{label} is inference-only: it has no backward yet")


def check_layout(activations):
    """Raise unless every activation (``None`` skipped) is channels_last
    contiguous (NHWC memory), as the kernels read it."""
    for name, t in activations.items():
        if t is not None and not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last contiguous (NHWC memory)")


def use_plain_version(label, x):
    """A wrapper's dispatch: True for a CPU tensor (take the plain
    version), False for a CUDA tensor (launch the kernel), raise for any
    other device."""
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{label} runs on CUDA devices (or the plain version on "
                         f"the CPU), got a {x.device.type} tensor")
    return True


def launch(label, entry, argtypes, tensors, *scalars):
    """One launch of kernel ``label``: its C entry ``entry`` (which returns
    a CUDA error code) with the data pointers of ``tensors`` (None for an
    absent operand), then ``scalars``, then the current stream of
    ``tensors[0]``'s device; ``argtypes`` are the C types of all of them.
    Raises on a non-zero error; counts the launch in :data:`COUNTER`.

    A launch keeps its host time short (K7 runs once a conv): the device
    is switched only where it is not already current, and the stream is
    read as the raw handle (``torch.cuda.current_stream(...).cuda_stream``
    builds a Stream object: 7 us a call on the card's host, against 0.2).
    Under a CUDA graph's capture the current stream is the capture
    stream, so the graph records the launch."""
    fn = _build.function(entry, argtypes)
    dev = tensors[0].get_device()
    if dev != torch._C._cuda_getDevice():  # torch.cuda.current_device() less its lazy init
        with torch.cuda.device(dev):
            return launch(label, entry, argtypes, tensors, *scalars)
    err = fn(*[None if t is None else t.data_ptr() for t in tensors], *scalars,
             torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{label} launch failed: CUDA error {err}")
    COUNTER[label] += 1


class Op:
    """A kernel registered as the custom op ``fastdepth::<name>``
    (:func:`register`).  :attr:`overload` is the op itself, what a trace
    records and a saved program runs; calling the ``Op`` is the eager
    dispatch.  On ``args``, whose first is the tensor that decides the
    device: under a trace (``torch.export``, ``torch.compile``) the op,
    one node in the graph; otherwise :attr:`cpu` or :attr:`cuda`
    (:func:`use_plain_version`), called directly, without the
    dispatcher's host time, inside the span of the op's name
    (``engine/profiler``).  The caller checked the operands.

    K7 runs once a conv, so the eager call keeps its host time short:
    with no profiler running the span costs one read of the flag that
    ``torch.profiler`` sets (``annotate``'s shared no-op context would
    add its enter and exit)."""

    __slots__ = ("overload", "label", "span", "cpu", "cuda")

    def __init__(self, overload, label: str, span: str, cpu: Callable, cuda: Callable):
        self.overload, self.label, self.span, self.cpu, self.cuda = (
            overload, label, span, cpu, cuda)

    def __call__(self, *args):
        if torch.compiler.is_compiling():
            return self.overload(*args)
        impl = self.cpu if use_plain_version(self.label, args[0]) else self.cuda
        if not _autograd_profiler._is_profiler_enabled:
            return impl(*args)
        with torch.profiler.record_function(self.span):
            return impl(*args)


def register(label: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable,
             eager: Optional[Callable] = None) -> Op:
    """Kernel ``label`` as the custom op ``fastdepth::<schema>``: ``cpu``
    (the plain version) on the CPU, ``cuda`` (the kernel) on CUDA, and
    ``fake`` (shapes, dtype and strides only) for a trace; no autograd
    (the TPU kernels have no VJP either).  ``eager``, where given, takes
    ``cuda``'s place in an eager call (K7 writes its input in place
    there; its op, which may write none of its inputs, allocates).
    Returns the :class:`Op`."""
    name = schema[:schema.index("(")]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"fastdepth::{name}", fake, lib=_LIBRARY)
    return Op(getattr(torch.ops.fastdepth, name).default, label, f"fastdepth::{name}", cpu,
              eager or cuda)
