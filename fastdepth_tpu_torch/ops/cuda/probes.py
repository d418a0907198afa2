"""K5 and K6: the probe kernels of the JAX package's ``scripts/``, hand-written
for Hopper.

The TPU probes staged arrays through VMEM with manual DMA, either to find
what the Mosaic compiler accepted (``scripts/bisect_v3*.py``) or to
measure DMA bandwidth (``scripts/probe_xla_opts.py::dma_copy``).  On the
card the same staging runs through shared memory:

* **K5** :func:`staged_copy` (``csrc/probe_copy.cu``): ``out = a * x``,
  plus each pixel's channel 0 with ``bcast_c0``, through a ring of one or
  two shared-memory slots of ``chunk_bytes`` each, with or without the
  next chunk's copy in flight.  It replaces ``bisect_v3.py`` ``k_a``-``k_d``,
  ``bisect_v3d.py`` ``flat_dma``, ``vmem_autocopy_small_lane`` and
  ``dma_2d_small_lane``, ``bisect_v3e.py`` ``rank3_folded_dma`` and
  ``value_reshape_split``, and ``probe_xla_opts.py`` ``dma_copy``.
* **K6** :func:`staged_compute` (``csrc/probe_stage.cu``): one image of
  an NHWC f32 input staged into shared memory, then one op of the decoder
  stage (``MODES``).  It replaces ``bisect_v3c.py`` ``make_kernel`` and
  ``bisect_v3d.py`` ``dma_matmul``.

The probes' catalogue, with the scripts' inputs, is
``engine/probes.py``; its CLI is ``cli/probe.py``.

Dispatch: a CPU tensor takes the plain version
(:func:`staged_copy_reference`, :func:`staged_compute_reference`); a CUDA
tensor launches the kernel or raises.  ``COPY_LAUNCHES`` and
``STAGE_LAUNCHES`` count the launches of K5 and K6 and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda.fused_decoder import DTYPES, use_plain_version

COPY_LAUNCHES = 0
STAGE_LAUNCHES = 0

SMEM_BYTES = 232448  # the shared memory a block can use on the H100 (227 KB)
MODES = ("matmul", "matmul_up", "taps", "up_only")
TAP_SCALE = 0.04  # bisect_v3c.py's taps weight


class CopyPlan(NamedTuple):
    """How K5 cuts an input: ``rows`` rows of ``row_len`` elements, each
    in ``ceil(row_len / chunk)`` chunks of at most ``chunk`` elements."""

    rows: int
    row_len: int
    chunk: int
    bcast_c: int


def plan_copy(shape, itemsize: int, *, chunk_bytes: Optional[int] = None, depth: int = 2,
              prefetch: bool = True, bcast_c0: bool = False) -> CopyPlan:
    """K5's cut of an input of ``shape``: a row is ``x[i]``, flattened.

    ``chunk_bytes`` (default: the whole row, or as much of it as ``depth``
    slots leave room for) is rounded down to a whole number of 16-byte
    words, so that chunks stay aligned for ``cp.async``, and with
    ``bcast_c0`` to a whole number of pixels (``shape[-1]`` channels), so
    that no chunk separates a pixel from its channel 0.  Raises on what
    the kernel does not take."""
    if len(shape) < 2:
        raise ValueError(f"K5 takes rows x[i]: x needs at least 2 dims, got {tuple(shape)}")
    if depth not in (1, 2):
        raise ValueError(f"depth must be 1 or 2 slots, got {depth}")
    if prefetch and depth != 2:
        raise ValueError("prefetch keeps the next chunk in flight: it needs depth 2")
    rows = int(shape[0])
    row_len = 1
    for s in shape[1:]:
        row_len *= int(s)
    cap = SMEM_BYTES // depth
    if chunk_bytes is None:
        chunk_bytes = min(row_len * itemsize, cap)
    if chunk_bytes < itemsize or chunk_bytes > cap:
        raise ValueError(f"chunk_bytes must lie in [{itemsize}, {cap}] for {depth} slot(s) "
                         f"in {SMEM_BYTES} bytes of shared memory, got {chunk_bytes}")
    chunk = min(chunk_bytes // itemsize, row_len)
    bcast_c = int(shape[-1]) if bcast_c0 else 0
    if bcast_c:
        chunk -= chunk % bcast_c
        if chunk == 0:
            raise ValueError(f"a chunk of {chunk_bytes} bytes holds no whole pixel of "
                             f"{bcast_c} channels")
    elif chunk < row_len:
        words = 16 // itemsize
        if chunk >= words:
            chunk -= chunk % words
    return CopyPlan(rows, row_len, chunk, bcast_c)


def staged_copy_reference(x: torch.Tensor, scale: float = 2.0,
                          bcast_c0: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K5: ``a * x`` (+ ``x[..., :1]``) in f32,
    cast back to ``x``'s dtype."""
    y = x.float() * scale
    if bcast_c0:
        y = y + x[..., :1].float()
    return y.to(x.dtype)


def staged_copy(x: torch.Tensor, *, scale: float = 2.0, chunk_bytes: Optional[int] = None,
                depth: int = 2, prefetch: bool = True, bcast_c0: bool = False,
                blocks: Optional[int] = None) -> torch.Tensor:
    """K5 on a dense f32 or bf16 ``x`` of at least 2 dims: returns
    ``scale * x`` (``+ x[..., :1]`` with ``bcast_c0``) in ``x``'s shape and
    dtype.  ``chunk_bytes``, ``depth`` and ``prefetch`` set the ring
    (:func:`plan_copy`); ``blocks`` the persistent grid (default: as many
    blocks as fit on the card at once; 1 is the scripts' one program
    walking the rows).  On the CPU this is the plain version; on a CUDA
    tensor it launches K5 or raises."""
    global COPY_LAUNCHES
    if x.dtype not in DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("K5 takes a contiguous x")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    plan = plan_copy(x.shape, x.element_size(), chunk_bytes=chunk_bytes, depth=depth,
                     prefetch=prefetch, bcast_c0=bcast_c0)
    if use_plain_version("K5", x):
        return staged_copy_reference(x, scale, bcast_c0)
    out = torch.empty_like(x)
    fn = _build.function("fd_staged_copy", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), plan.rows, plan.row_len, plan.chunk, scale,
                 plan.bcast_c, depth, int(prefetch), blocks or 0, DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    COPY_LAUNCHES += 1
    return out


def staged_compute_reference(x: torch.Tensor, w: Optional[torch.Tensor],
                             mode: str) -> torch.Tensor:
    """Plain PyTorch version of K6 (same arguments), in f32."""
    N, H, W, C = x.shape
    if mode in ("matmul", "matmul_up"):
        y = torch.matmul(x.reshape(N * H * W, C), w).reshape(N, H, W, -1)
        return _up2(y) if mode == "matmul_up" else y
    if mode == "up_only":
        return _up2(x)
    pad = F.pad(x, (0, 0, 2, 2, 2, 2))
    acc = torch.zeros_like(x)
    for dw in range(5):  # the script's order: dw outer, dh inner
        sh = pad[:, :, dw:dw + W, :]
        for dh in range(5):
            acc = acc + sh[:, dh:dh + H] * TAP_SCALE
    return acc


def _up2(y: torch.Tensor) -> torch.Tensor:
    """NHWC nearest x2."""
    N, H, W, C = y.shape
    return y[:, :, None, :, None, :].expand(N, H, 2, W, 2, C).reshape(N, 2 * H, 2 * W, C)


def staged_compute(x: torch.Tensor, w: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """K6 on a dense f32 NHWC ``x (N, H, W, C)``: ``mode`` is one of
    :data:`MODES`; ``w (C, Cout)`` dense f32 for the matmul modes, None
    for ``taps`` and ``up_only``.  Returns ``(N, H, W, Cout)``
    (``matmul``), ``(N, 2H, 2W, Cout)`` (``matmul_up``), ``(N, H, W, C)``
    (``taps``) or ``(N, 2H, 2W, C)`` (``up_only``).  On the CPU this is
    the plain version; on a CUDA tensor it launches K6 or raises."""
    global STAGE_LAUNCHES
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (N, H, W, C), got {tuple(x.shape)}")
    N, H, W, C = x.shape
    matmul = mode in ("matmul", "matmul_up")
    if matmul:
        if w is None or w.dim() != 2 or w.shape[0] != C:
            raise ValueError(f"w must be (C={C}, Cout), got "
                             f"{None if w is None else tuple(w.shape)}")
    elif w is not None:
        raise ValueError(f"mode {mode!r} takes no weight")
    tensors = [x] + ([w] if matmul else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("K6 takes float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("K6 takes contiguous operands")
    if any(t.device != x.device for t in tensors):
        raise ValueError("K6's operands must lie on one device")
    if H * W * C * 4 > SMEM_BYTES:
        raise ValueError(f"one image's {H}x{W}x{C} f32 tile exceeds the {SMEM_BYTES} bytes "
                         "of shared memory a block can use")
    if use_plain_version("K6", x):
        return staged_compute_reference(x, w, mode)
    Cout = w.shape[1] if matmul else C
    hw = (2 * H, 2 * W) if mode in ("matmul_up", "up_only") else (H, W)
    out = torch.empty((N, *hw, Cout), dtype=x.dtype, device=x.device)
    fn = _build.function("fd_staged_compute", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr() if matmul else None, out.data_ptr(), N, H, W, C,
                 Cout, MODES.index(mode), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    STAGE_LAUNCHES += 1
    return out
