"""K8: the depth metrics' masked sums, a hand-written Hopper kernel.

It replaces no Pallas kernel: on the TPU, XLA fused the metric ops.  On
the card ATen runs ``metrics.metric_sums_reference`` op by op, some sixty
launches an evaluation step.  K8 reads each pixel of the (N, H, W, 1)
prediction and target once and writes the same ``(10, N)`` f32 stack:
each image's nine masked sums (``metrics.SUM_FIELDS``), then its
valid-pixel count, each per-pixel term rounded as ATen rounds it, so that
only the order of the sums differs from the plain version (the counts
come out exact).  The CUDA source is
``fastdepth_tpu_torch/csrc/metric_sums.cu`` (its header states the byte
bound and the design, and the kernel picks its grid from N and H x W);
it is built by ``_build`` at the first launch.

Dispatch: ``metrics`` registers K8 as the custom op
``fastdepth::metric_sums`` (``metrics.METRIC_SUMS_OP``): its CPU kernel
is the plain version, its CUDA kernel :func:`metric_sums_cuda`, which
casts both maps to contiguous f32 and launches K8 or raises, its fake
:func:`metric_sums_fake`.  ``metrics.metric_sums`` checks the shapes and
calls the op's eager dispatch (inside the span
``fastdepth::metric_sums``).  Its launches count under "K8" in
``kernel.COUNTER``: one an evaluation step.
"""

from __future__ import annotations

import ctypes

import torch

from fastdepth_tpu_torch.ops.cuda import _build, kernel

FIELDS = 10  # the rows K8 writes: metrics.SUM_FIELDS, then the count
# the workspace's rows: one a block of the largest grid K8 picks, a wave of
# the card (at most 8 blocks of 256 threads fit an SM), or one an image
WAVE_ROWS = 8 * kernel.SMS

# fd_metric_sums(out, tgt, partials, sums, images, pixels, capacity, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
# fd_metric_sums_chunks(out, tgt, images, pixels, capacity, &chunks)
_CHUNKS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def _capacity(images: int) -> int:
    return max(images, WAVE_ROWS)


def metric_sums_cuda(output, target):
    """``fastdepth::metric_sums`` on CUDA: both maps as contiguous f32
    (the plain version's ``.float()``), then one launch of K8 into a new
    ``(FIELDS, N)`` output, with a workspace of :data:`WAVE_ROWS` rows of
    sums (or one an image, if more)."""
    output = output.float().contiguous()
    target = target.float().contiguous()
    n = output.shape[0]
    sums = metric_sums_fake(output, target)
    partials = torch.empty(_capacity(n) * FIELDS, dtype=torch.float32, device=output.device)
    kernel.launch("K8", "fd_metric_sums", _ARGTYPES, (output, target, partials, sums), n,
                  output.shape[1] * output.shape[2], _capacity(n))
    return sums


def metric_sums_fake(output, target):
    """The output the op writes: ``(FIELDS, N)`` f32 on the maps' device."""
    return torch.empty((FIELDS, output.shape[0]), dtype=torch.float32, device=output.device)


def chunks(output: torch.Tensor, target: torch.Tensor) -> int:
    """The chunks an image K8's launch cuts these contiguous f32 CUDA
    maps into, on their device (``fd_metric_sums_chunks``)."""
    got = ctypes.c_int()
    with torch.cuda.device(output.device):
        err = _build.function("fd_metric_sums_chunks", _CHUNKS_ARGTYPES)(
            output.data_ptr(), target.data_ptr(), output.shape[0],
            output.shape[1] * output.shape[2], _capacity(output.shape[0]),
            ctypes.addressof(got))
    if err != 0:
        raise RuntimeError(f"K8's grid failed: CUDA error {err}")
    return got.value
