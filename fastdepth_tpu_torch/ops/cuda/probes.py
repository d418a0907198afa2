"""K5 and K6: the probe kernels of the JAX package's ``scripts/``, hand-written
for Hopper.

The TPU probes staged arrays through VMEM with manual DMA, either to find
what the Mosaic compiler accepted (``scripts/bisect_v3*.py``) or to
measure DMA bandwidth (``scripts/probe_xla_opts.py::dma_copy``).  Their
one program (``grid=()``) walked the images in a loop, which on a one-core
TPU was the whole chip; on the card the same functions are cut over all
132 SMs:

* **K5** :func:`staged_copy` (``csrc/probe_copy.cu``): ``out = a * x``,
  plus each pixel's channel 0 with ``bcast_c0``, through a ring of one or
  two shared-memory slots, with or without the next chunk's copy in
  flight, on a persistent grid that fills the card; :func:`plan_copy`
  cuts the rows into chunks so that every resident block gets about two.
  It replaces ``bisect_v3.py`` ``k_a``-``k_d``, ``bisect_v3d.py``
  ``flat_dma``, ``vmem_autocopy_small_lane`` and ``dma_2d_small_lane``,
  ``bisect_v3e.py`` ``rank3_folded_dma`` and ``value_reshape_split``, and
  ``probe_xla_opts.py`` ``dma_copy``.
* **K6** :func:`staged_compute` (``csrc/probe_stage.cu``): one op of the
  decoder stage (``MODES``) on an NHWC f32 input, in tiles that
  :func:`stage_geometry` spreads over the card: a tiled GEMM over all
  N*H*W pixels (matmul, matmul_up), bands of rows with their halo
  (taps), a 16-byte copy to four places (up_only).  It replaces
  ``bisect_v3c.py`` ``make_kernel`` and ``bisect_v3d.py`` ``dma_matmul``.

The probes' catalogue, with the scripts' inputs, is
``engine/probes.py``; its CLI is ``cli/probe.py``.

Dispatch: a CPU tensor takes the plain version
(:func:`staged_copy_reference`, :func:`staged_compute_reference`); a CUDA
tensor launches the kernel or raises (``kernel.use_plain_version``).
Their launches count under "K5" and "K6" in ``kernel.COUNTER``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import kernel
from fastdepth_tpu_torch.ops.cuda.kernel import DTYPES, MAX_SMEM, SMEM_PER_SM, SMS

SMEM_BYTES = MAX_SMEM  # the shared memory a block can use on the H100 (227 KB)
MODES = ("matmul", "matmul_up", "taps", "up_only")
TAP_SCALE = 0.04  # bisect_v3c.py's taps weight

# K5's default grid holds at most 5 blocks of 256 threads an SM, what its
# kernels' registers allow (kBlocksPerSm in probe_copy.cu): with the next
# chunk in flight that is 40 KB of copies an SM at the least chunk, above
# the ~20 KB an SM's share of the device memory's rate x latency needs
# (3.35 TB/s x ~0.8 us / 132).  The least chunk the planner cuts is one
# 16-byte word a thread.
COPY_BLOCKS_PER_SM = 5
MIN_CHUNK_BYTES = 256 * 16


class CopyPlan(NamedTuple):
    """How K5 cuts an input: ``rows`` rows of ``row_len`` elements, each
    in ``ceil(row_len / chunk)`` chunks of at most ``chunk`` elements."""

    rows: int
    row_len: int
    chunk: int
    bcast_c: int


def resident_copy_blocks(depth: int, chunk_bytes: int) -> int:
    """K5's default grid with ``depth`` slots of ``chunk_bytes``: the
    blocks the card holds at once, by shared memory (each block with the
    1 KB the runtime keeps), at most :data:`COPY_BLOCKS_PER_SM` an SM."""
    per_sm = min(COPY_BLOCKS_PER_SM, SMEM_PER_SM // (depth * chunk_bytes + 1024))
    return SMS * max(1, per_sm)


def plan_copy(shape, itemsize: int, *, chunk_bytes: Optional[int] = None, depth: int = 2,
              prefetch: bool = True, bcast_c0: bool = False) -> CopyPlan:
    """K5's cut of an input of ``shape``: a row is ``x[i]``, flattened.

    By default a chunk starts as the whole row (or as much of it as
    ``depth`` slots leave room for) and halves, down to
    :data:`MIN_CHUNK_BYTES` (or one pixel, if larger), until the rows
    give at least two chunks to every block the card holds at once
    (:func:`resident_copy_blocks`).  An explicit ``chunk_bytes`` is kept
    as given.  Either is rounded down to a whole number of 16-byte words,
    so that chunks stay aligned for ``cp.async``, and with ``bcast_c0`` to
    a whole number of pixels (``shape[-1]`` channels), so that no chunk
    separates a pixel from its channel 0.  Raises on what the kernel does
    not take."""
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
    bcast_c = int(shape[-1]) if bcast_c0 else 0
    cap = SMEM_BYTES // depth
    if chunk_bytes is None:
        row_bytes = row_len * itemsize
        chunk_bytes = min(row_bytes, cap)
        least = max(MIN_CHUNK_BYTES, bcast_c * itemsize)
        while (chunk_bytes > least and rows * -(-row_bytes // chunk_bytes)
               < 2 * resident_copy_blocks(depth, chunk_bytes)):
            chunk_bytes = max(least, chunk_bytes // 2)
    if chunk_bytes < itemsize or chunk_bytes > cap:
        raise ValueError(f"chunk_bytes must lie in [{itemsize}, {cap}] for {depth} slot(s) "
                         f"in {SMEM_BYTES} bytes of shared memory, got {chunk_bytes}")
    chunk = min(chunk_bytes // itemsize, row_len)
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


# fd_staged_copy(x, out, rows, row_len, chunk, scale, bcast_c, depth, prefetch,
# blocks, dtype, stream)
_COPY_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def staged_copy(x: torch.Tensor, *, scale: float = 2.0, chunk_bytes: Optional[int] = None,
                depth: int = 2, prefetch: bool = True, bcast_c0: bool = False,
                blocks: Optional[int] = None) -> torch.Tensor:
    """K5 on a dense f32 or bf16 ``x`` of at least 2 dims: returns
    ``scale * x`` (``+ x[..., :1]`` with ``bcast_c0``) in ``x``'s shape and
    dtype.  ``chunk_bytes``, ``depth`` and ``prefetch`` set the ring
    (:func:`plan_copy`); ``blocks`` the persistent grid (default:
    :func:`resident_copy_blocks`, what the card holds at once; the tests
    pass a small grid so that one block walks several items through its
    ring).  On the CPU this is the plain version; on a CUDA tensor it
    launches K5 or raises."""
    if x.dtype not in DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("K5 takes a contiguous x")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    plan = plan_copy(x.shape, x.element_size(), chunk_bytes=chunk_bytes, depth=depth,
                     prefetch=prefetch, bcast_c0=bcast_c0)
    if kernel.use_plain_version("K5", x):
        return staged_copy_reference(x, scale, bcast_c0)
    out = torch.empty_like(x)
    if blocks is None:
        blocks = resident_copy_blocks(depth, plan.chunk * x.element_size())
    kernel.launch("K5", "fd_staged_copy", _COPY_ARGTYPES, (x, out), plan.rows, plan.row_len,
                  plan.chunk, scale, plan.bcast_c, depth, int(prefetch), blocks, DTYPES[x.dtype])
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


# K6's GEMM tiles: (pixels, Cout) a block, pixels a thread (each thread 4
# neighbouring output channels of those pixels).  The first three (128 or
# 256 threads) are for grids that cover the card; the last, of one warp,
# spreads a small product over the most blocks
GEMM_TILES = ((128, 32, 8), (64, 64, 4), (64, 32, 4), (32, 16, 4))
TAP_BANDS = (8, 4, 2, 1)  # rows of one image a taps block computes
TAP_CHANNELS = 32  # channels a taps block computes (at most)


class StageGeometry(NamedTuple):
    """One launch of K6: ``grid`` blocks of ``threads``; ``tile_m`` x
    ``tile_n`` is (pixels, Cout) of a GEMM block, or (rows, channels) of
    a taps block, whose dynamic shared memory is ``smem`` bytes."""

    grid: Tuple[int, int]
    threads: int
    tile_m: int
    tile_n: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def stage_geometry(mode: str, N: int, H: int, W: int, C: int, Cout: int) -> StageGeometry:
    """K6's launch for ``mode`` on x ``(N, H, W, C)``, in closed form.

    * matmul, matmul_up: the N*H*W pixels are the GEMM's M.  Of the
      :data:`GEMM_TILES` of at least 128 threads whose grid covers the
      card's SMs, the one that pads M and Cout least (the larger tile on
      a tie); where none covers them, the tile with the most blocks.
    * taps: a block stages ``tile_m`` rows of one image (the largest of
      :data:`TAP_BANDS` whose grid covers the SMs, else 1) with their
      +-2-row halo, for ``tile_n`` channels (:data:`TAP_CHANNELS`, or C
      rounded up to a power of two, at least 4); one thread per strip of
      min(4, ``tile_m``) rows of a pixel column and 4 channels, at most
      256.  Raises where even one row of the least tile does not fit in
      shared memory.
    * up_only: one thread per 16-byte word of channels, 256 a block."""
    if mode in ("matmul", "matmul_up"):
        M = N * H * W
        options = [((_cdiv(M, bm), _cdiv(Cout, bn)), bm, bn, bm * bn // (4 * tm))
                   for bm, bn, tm in GEMM_TILES]
        cover = [o for o in options if o[0][0] * o[0][1] >= SMS and o[3] >= 128]
        if cover:
            grid, bm, bn, threads = min(cover, key=lambda o: o[0][0] * o[1] * o[0][1] * o[2])
        else:
            grid, bm, bn, threads = max(options, key=lambda o: o[0][0] * o[0][1])
        if grid[1] > 65535:
            raise ValueError(f"K6's GEMM grid {grid} is too large for one launch")
        return StageGeometry(grid, threads, bm, bn, 0)
    if mode == "taps":
        ct = min(TAP_CHANNELS, max(4, 1 << (C - 1).bit_length()))
        while (1 + 4) * W * ct * 4 > SMEM_BYTES and ct > 4:
            ct //= 2
        fit = [r for r in TAP_BANDS if (r + 4) * W * ct * 4 <= SMEM_BYTES]
        if not fit:
            raise ValueError(f"taps stages rows of {W} pixels: one row of 4 channels with "
                             f"its halo exceeds the {SMEM_BYTES} bytes of shared memory")
        grid_of = {r: (N * _cdiv(H, r), _cdiv(C, ct)) for r in fit}
        r = next((r for r in fit if grid_of[r][0] * grid_of[r][1] >= SMS), fit[-1])
        items = r // min(4, r) * W * ct // 4
        threads = min(256, max(32, 1 << (items - 1).bit_length()))
        return StageGeometry(grid_of[r], threads, r, ct, (r + 4) * W * ct * 4)
    if mode == "up_only":
        return StageGeometry((_cdiv(N * H * W * _cdiv(C, 4), 256), 1), 256, 0, 0, 0)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def staged_compute(x: torch.Tensor, w: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """K6 on a dense f32 NHWC ``x (N, H, W, C)``: ``mode`` is one of
    :data:`MODES`; ``w (C, Cout)`` dense f32 for the matmul modes, None
    for ``taps`` and ``up_only``.  Returns ``(N, H, W, Cout)``
    (``matmul``), ``(N, 2H, 2W, Cout)`` (``matmul_up``), ``(N, H, W, C)``
    (``taps``) or ``(N, 2H, 2W, C)`` (``up_only``).  On the CPU this is
    the plain version; on a CUDA tensor it launches K6 or raises."""
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
    Cout = w.shape[1] if matmul else C
    g = stage_geometry(mode, N, H, W, C, Cout)
    if kernel.use_plain_version("K6", x):
        return staged_compute_reference(x, w, mode)
    hw = (2 * H, 2 * W) if mode in ("matmul_up", "up_only") else (H, W)
    out = torch.empty((N, *hw, Cout), dtype=x.dtype, device=x.device)
    kernel.launch("K6", "fd_staged_compute", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p], (x, w if matmul else None, out), N, H, W, C, Cout,
                  MODES.index(mode), g.tile_m, g.tile_n, g.threads)
    return out
