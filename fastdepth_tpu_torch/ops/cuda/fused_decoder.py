"""K1: the fused FastDepth decoder stage, a hand-written Hopper kernel.

Counterpart of the Pallas TPU kernel
``fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage``: one
launch runs a whole NNConv5(dw) decoder level,

    dw5x5 (+folded-BN bias) -> ReLU -> pw1x1 (+bias) -> ReLU
        -> nearest x2 upsample -> [+ skip]

with the intermediates kept out of device memory.  The CUDA source is
``fastdepth_tpu_torch/csrc/fused_decoder.cu`` (its header says what
bounds the kernel on the card and how the design answers it); it is built
by ``_build`` at the first launch.  :func:`launch_geometry` picks the
launch (threads, pixel tile, Cout tile, C chunk, grid, shared memory) in
closed form from the shapes and the dtype.

Layouts: activations are logical NCHW tensors stored channels_last
(NHWC memory), so the kernel reads the encoder's cuDNN output with no
transpose.  Weights come in K1's own layout, ``dw_w (25, C)`` and
``pw_w (C, Cout)``; :func:`kernel_weights` derives it from the OIHW
weights once, when the model is folded.

Row window: under a height-sharded mesh (``parallel/spatial.py``) a rank
holds some rows of each map.  ``window=(r0, H, o0, o1)`` says that ``x``
holds rows ``r0 .. r0 + x.shape[2] - 1`` of an image of ``H`` rows (its
halo rows included; rows outside ``[0, H)`` count as zero, whatever the
tile holds there) and asks for rows ``o0 .. o1 - 1`` of the ``2H``-row
output; the skip and the result hold those rows only.  The kernel tiles
only the input rows the window duplicates, so a window costs its share
of the level and no padded copy of the skip.

Dispatch: K1 is the custom op ``fastdepth::fused_decoder_stage``
(``torch.library``, registered when this module is imported), so that
``torch.export`` records a level as one node (``engine/aot.save_bundle``).
Its CPU kernel is :func:`fused_decoder_stage_reference`, the plain
PyTorch version of the same math; its CUDA kernel launches K1 or raises;
any other device raises.  :func:`fused_decoder_stage` checks the
operands, then calls the op under a trace and the same implementation
directly in eager mode.  ``LAUNCHES`` counts the launches of K1 and
nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops.cuda import _build

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535

SMS = 132  # an H100 SXM's streaming multiprocessors
MAX_SMEM = 232448  # the most shared memory a Hopper block may have (227 KB)
SMEM_PER_SM = 233472  # 228 KB an SM
# K1-K3 take at most 128 registers a thread (__launch_bounds__(256, 2)),
# so an SM's 64 K registers hold 512 / threads blocks of a launch
REG_THREADS_PER_SM = 512
# pixels -> (rows, columns) of a block's pixel tile (of each image); the
# 4-pixel tile only where an image group of K2 or K3 fills the rest
TILES = {4: (1, 4), 8: (2, 4), 16: (4, 4), 32: (4, 8), 64: (8, 8), 128: (8, 16),
         256: (16, 16), 512: (16, 32)}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of K1 (or K2 / K3): each block a ``tile_h`` x ``tile_w``
    pixel tile of ``images`` images (K1: one) and ``cout_tile`` output
    channels, its ``groups`` x ``threads`` threads in ``groups`` groups
    that walk every ``groups``-th chunk of ``chunk`` channels of C;
    ``grid`` is (image groups x tiles, Cout tiles), the work items of
    K3's persistent walk, ``smem`` the dynamic shared memory in bytes and
    ``per_sm`` the blocks an SM holds (registers and shared memory)."""

    threads: int
    tile_h: int
    tile_w: int
    cout_tile: int
    chunk: int
    groups: int
    grid: Tuple[int, int]
    smem: int
    images: int = 1
    per_sm: int = 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tile_h: int, tile_w: int, cout_tile: int, chunk: int, bf16: bool,
               groups: int = 1, images: int = 1, persistent: bool = False) -> int:
    """The block's shared memory (``Layout`` in fused_decoder.cu, and in
    stage_tile.cuh for K2 / K3), per
    group: two slots, each the halos of the ``images`` images, the
    pointwise weight and the depthwise taps (25 rows and the bias) of a
    chunk, and two depthwise tiles in the main loop; in the epilogue,
    each group's f32 output tile over the same bytes (one item a block),
    or (``persistent``, K3) one f32 output tile for the block after
    them."""
    elem = 2 if bf16 else 4
    m = tile_h * tile_w * images
    pix_words = chunk * elem // 4
    pad_words = (pix_words * (1 - (tile_w + 4))) % 32  # rows kPixWords banks apart
    halo = images * (tile_h + 4) * ((tile_w + 4) * chunk * elem + 4 * pad_words)
    pw = chunk * (cout_tile + 8 if bf16 else cout_tile) * elem
    taps = 26 * chunk * elem
    dw = m * (chunk + 8) * 2 if bf16 else chunk * (m + 4) * 4
    main, epi = 2 * (halo + pw + taps + dw), m * (cout_tile + 4) * 4
    return groups * main + epi if persistent else groups * max(main, epi)


def _launch(N: int, H: int, W: int, C: int, Cout: int, bf16: bool, images: int,
            persistent: bool, threads: int) -> Optional[Geometry]:
    """The launch with ``threads`` threads a group (see
    :func:`launch_geometry`), or None where its pixel tile does not exist."""
    lanes, p_min = (32, 32) if bf16 else (8, 8)
    p_min = max(p_min, 4 * images)
    nc_all = min(256, max(lanes, 1 << (Cout - 1).bit_length()))
    nc = min(nc_all, threads * 32 // p_min)
    p = threads * 32 // nc // images
    if p > max(TILES):
        return None
    th, tw = TILES[p]
    grid = (_cdiv(N, images) * _cdiv(H, th) * _cdiv(W, tw), _cdiv(Cout, nc))
    blocks = grid[0] * grid[1]
    chunks = (32, 16) if bf16 else (32, 16, 8)
    groups = 1
    while (2 * groups * threads <= 256 and blocks * threads * groups < SMS * 1024
           and 2 * groups <= _cdiv(C, chunks[-1])):
        groups *= 2
    per_sm = min(REG_THREADS_PER_SM // (threads * groups), _cdiv(blocks, SMS))
    budget = SMEM_PER_SM // per_sm - 1024  # each block with the 1 KB the runtime keeps

    def smem(k, groups):
        return smem_bytes(th, tw, nc, k, bf16, groups, images, persistent)

    chunk = next((k for k in chunks if groups <= _cdiv(C, k) and smem(k, groups) <= budget),
                 chunks[-1])
    while smem(chunk, groups) > MAX_SMEM:
        if groups == 1:
            return None
        groups //= 2
    held = min(REG_THREADS_PER_SM // (threads * groups),
               SMEM_PER_SM // (smem(chunk, groups) + 1024))
    return Geometry(threads, th, tw, nc, chunk, groups, grid, smem(chunk, groups), images,
                    held)


def serial_work(g: Geometry, C: int, bf16: bool) -> float:
    """A closed-form estimate of the busiest SM's work for launch ``g``,
    in f32 FMAs a thread: the waves of blocks the card holds at once,
    times the channels each group walks, times a thread's work a channel
    (its pointwise product: 32 FMAs on the CUDA cores, about 4 on the
    tensor cores; its share of the depthwise pass, 25 taps over the
    tile's rows, 800 / Cout tile; its share of the halo loads, about 2 a
    value)."""
    waves = _cdiv(g.blocks, SMS * g.per_sm)
    channels = _cdiv(C, g.groups * g.chunk) * g.chunk
    halo = g.images * (g.tile_h + 4) * (g.tile_w + 4) / g.threads
    return waves * channels * ((4 if bf16 else 32) + 800 / g.cout_tile + 2 * halo)


@functools.lru_cache(maxsize=None)
def launch_geometry(N: int, H: int, W: int, C: int, Cout: int, dtype: torch.dtype,
                    images: int = 1, persistent: bool = False) -> Geometry:
    """K1's launch for one level, in closed form; with ``images`` > 1 the
    launch of K2 (image groups), with ``persistent`` K3's blocks.

    A block of ``T`` threads computes ``32 T`` outputs per item (f32:
    each thread 4 rows x 8 channels; bf16: each warp 32 x 32), so rows x
    Cout tile = ``32 T``, where the rows are ``images`` x the pixel tile
    of each.  The Cout tile is all of Cout (rounded up to a power of two:
    a multiple of 8 in f32, of 32 in bf16) up to 256, and the rows are at
    least 8 (f32) or 32 (bf16), and at least 4 pixels an image.  A
    smaller ``T`` shrinks the pixel tile and, once it is at its least,
    splits Cout into more tiles (each recomputing the depthwise pass and
    re-reading the halo).  For one image ``T`` is the largest of 256 (128
    for an f32 Cout tile of at most 64), 128, 64, 32 whose grid covers the
    card's SMs once; where even 32 threads leave SMs idle, the grid is the
    largest there is.  An image group's tile is at its least sooner, and
    its block may hold so much shared memory that a grid covering the SMs
    takes two waves: so for ``images`` > 1 that ``T`` is only the least,
    and a larger one (less Cout split) is taken where it has less
    :func:`serial_work` (the larger on a tie).

    Where the grid holds fewer than 1024 threads an SM, each block runs
    up to 256 / ``T`` groups of ``T`` threads that split C between them,
    at most one group a chunk; the groups' partial products are summed in
    a fixed order.  The C chunk (32, 16 or 8 channels; bf16 32 or 16) is
    the largest whose shared memory leaves room for as many blocks an SM
    as the registers hold (at most 128 a thread) or the grid puts there;
    where even the least does not fit, the groups halve."""
    if dtype not in DTYPES:
        raise ValueError(f"K1 takes float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    nc_all = min(256, max(32 if bf16 else 8, 1 << (Cout - 1).bit_length()))
    # f32 levels whose Cout tile is at most 64 wide (the pruned levels 4-5)
    # take at most 128 threads a block: their weight chunks are small, and
    # four blocks an SM hide each other's barriers better than two
    sizes = (128, 64, 32) if not bf16 and nc_all <= 64 else (256, 128, 64, 32)
    options = [g for g in (_launch(N, H, W, C, Cout, bf16, images, persistent, t)
                           for t in sizes) if g is not None]
    if not options:
        raise ValueError(f"no launch of {images} images a block fits shared memory at "
                         f"{(N, H, W, C, Cout)}")
    pick = next((g for g in options if g.blocks >= SMS),
                max(options, key=lambda g: (g.blocks, g.threads)))
    if images > 1:  # split Cout only as far as it pays
        pick = min((g for g in options if g.threads >= pick.threads),
                   key=lambda g: (serial_work(g, C, bf16), -g.threads))
    return pick


def kernel_weights(dw_w: torch.Tensor, pw_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW depthwise ``(C, 1, 5, 5)`` and pointwise ``(Cout, C, 1, 1)``
    weights -> K1's ``(25, C)`` (tap-major) and ``(C, Cout)``."""
    C, Cout = dw_w.shape[0], pw_w.shape[0]
    if tuple(dw_w.shape) != (C, 1, 5, 5) or tuple(pw_w.shape) != (Cout, C, 1, 1):
        raise ValueError(
            f"K1 takes a 5x5 depthwise and a 1x1 pointwise weight; got "
            f"{tuple(dw_w.shape)} and {tuple(pw_w.shape)}")
    return (dw_w.reshape(C, 25).t().contiguous(),
            pw_w.reshape(Cout, C).t().contiguous())


def window_rows(window, rows: int) -> Tuple[int, int]:
    """Check a row window ``(r0, H, o0, o1)`` against a tile of ``rows``
    rows; returns ``(c0, c1)``, the input rows the output rows ``o0 ..
    o1 - 1`` duplicate.  The tile must hold every image row they read:
    two around ``c0 .. c1 - 1``, clipped to the image."""
    r0, h, o0, o1 = window
    if not 0 <= o0 < o1 <= 2 * h:
        raise ValueError(f"row window: output rows [{o0}, {o1}) are not inside the "
                         f"{2 * h}-row map")
    c0, c1 = o0 // 2, (o1 + 1) // 2
    if not (r0 <= max(c0 - 2, 0) and min(c1 + 2, h) <= r0 + rows):
        raise ValueError(f"row window: output rows [{o0}, {o1}) read image rows "
                         f"[{max(c0 - 2, 0)}, {min(c1 + 2, h)}); the tile holds "
                         f"[{r0}, {r0 + rows})")
    return c0, c1


def fused_decoder_stage_reference(x, dw_w, dw_b, pw_w, pw_b, skip=None, window=None):
    """Plain PyTorch version of K1 (same arguments): computed in f32 (f64
    stays f64) and cast back to ``x``'s dtype, like the TPU kernel.  With
    ``window`` (module docstring) it is the stage of the zero-extended
    tile sliced to rows ``o0 .. o1 - 1``, computed on the rows those need
    alone: the tile's image rows ``c0 - 2 .. c1 + 1``, zero outside the
    image, with no padding along the height; the whole image's window is
    the call without one."""
    C, Cout = pw_w.shape
    f32 = torch.promote_types(x.dtype, torch.float32)
    pad, crop = 2, None
    if window is not None and tuple(window) != (0, x.shape[2], 0, 2 * x.shape[2]):
        r0, h, o0, o1 = window
        c0, c1 = window_rows(window, x.shape[2])
        ext = x.new_zeros((x.shape[0], C, c1 - c0 + 4, x.shape[3]))
        lo, hi = max(c0 - 2, 0, r0), min(c1 + 2, h, r0 + x.shape[2])
        ext[:, :, lo - (c0 - 2):hi - (c0 - 2)] = x[:, :, lo - r0:hi - r0]
        x, pad, crop = ext, (0, 2), (o0 - 2 * c0, o1 - 2 * c0)
    y = F.conv2d(x.to(f32), dw_w.to(f32).t().reshape(C, 1, 5, 5),
                 dw_b.to(f32), padding=pad, groups=C)
    y = F.conv2d(torch.relu(y), pw_w.to(f32).t().reshape(Cout, C, 1, 1),
                 pw_b.to(f32))
    y = F.interpolate(torch.relu(y), scale_factor=2, mode="nearest")
    if crop is not None:
        y = y[:, :, crop[0]:crop[1]]
    if skip is not None:
        y = y + skip.to(f32)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def check_stage(x, dw_w, dw_b, pw_w, pw_b, skip, label, out_rows):
    """Validate a stage's operands for kernel ``label`` (K1-K3 take the
    same ones); ``out_rows``: the rows of the output and the skip (2H for
    the whole image).  Returns (N, C, H, W, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if pw_w.dim() != 2 or pw_w.shape[0] != C:
        raise ValueError(f"pw_w must be (C={C}, Cout), got {tuple(pw_w.shape)}")
    Cout = pw_w.shape[1]
    want = {"dw_w": (dw_w, (25, C)), "dw_b": (dw_b, (C,)), "pw_b": (pw_b, (Cout,))}
    if skip is not None:
        want["skip"] = (skip, (N, Cout, out_rows, 2 * W))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    check_operands(label, {"x": x, "skip": skip},
                   {"dw_w": dw_w, "dw_b": dw_b, "pw_w": pw_w, "pw_b": pw_b})
    return N, C, H, W, Cout


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
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA devices (or the plain version on "
                         f"the CPU), got a {x.device.type} tensor")
    return False


def launch_stage(entry, label, x, dw_w, dw_b, pw_w, pw_b, skip, out_rows, extra=()):
    """Allocate a stage's output of ``out_rows`` rows and launch the C entry ``entry`` of K1-K3 (seven pointers, N, H, W, C,
    Cout, the ``extra`` ints, dtype, stream) on the current stream; raise
    on a non-zero CUDA error."""
    N, C, H, W = x.shape
    Cout = pw_w.shape[1]
    fn = _build.function(entry, [ctypes.c_void_p] * 7 + [ctypes.c_int] * (6 + len(extra))
                         + [ctypes.c_void_p])
    out = torch.empty((N, Cout, out_rows, 2 * W),
                      dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
            pw_b.data_ptr(), skip.data_ptr() if skip is not None else None,
            out.data_ptr(), N, H, W, C, Cout, *extra, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{label} launch failed: CUDA error {err}")
    return out


def fused_decoder_stage(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                        pw_w: torch.Tensor, pw_b: torch.Tensor,
                        skip: Optional[torch.Tensor] = None,
                        window: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """One fused decoder level.

    x ``(N, C, H, W)`` and skip ``(N, Cout, 2H, 2W)`` channels_last;
    dw_w ``(25, C)``, dw_b ``(C,)``, pw_w ``(C, Cout)``, pw_b ``(Cout,)``
    (:func:`kernel_weights`).  Returns ``(N, Cout, 2H, 2W)``
    channels_last in ``x``'s dtype.  With ``window=(r0, Hg, o0, o1)``
    (module docstring) x is a tile of an image of Hg rows, and skip and
    the result hold rows ``o0 .. o1 - 1`` of its ``2Hg``-row output.  On
    the CPU this is the plain version; on a CUDA tensor it launches K1 or
    raises.  The operands are checked here.  Under a trace
    (``torch.export``, ``torch.compile``) the call goes through the custom
    op ``fastdepth::fused_decoder_stage`` (:data:`STAGE_OP`), one node in
    the graph; an eager call goes straight to the op's implementation
    for its device, without the dispatcher's host time (PERF.md §6)."""
    rows = x.shape[-2]
    window = (0, rows, 0, 2 * rows) if window is None else tuple(int(v) for v in window)
    check_stage(x, dw_w, dw_b, pw_w, pw_b, skip, "K1", window[3] - window[2])
    window_rows(window, rows)
    if torch.compiler.is_compiling():
        return STAGE_OP(x, dw_w, dw_b, pw_w, pw_b, skip, list(window))
    impl = _stage_cpu if use_plain_version("K1", x) else _stage_cuda
    return impl(x, dw_w, dw_b, pw_w, pw_b, skip, window)


def _stage_cpu(x, dw_w, dw_b, pw_w, pw_b, skip, window):
    """``fastdepth::fused_decoder_stage`` on the CPU: the plain version."""
    return fused_decoder_stage_reference(x, dw_w, dw_b, pw_w, pw_b, skip, window)


def _stage_cuda(x, dw_w, dw_b, pw_w, pw_b, skip, window):
    """``fastdepth::fused_decoder_stage`` on CUDA: one launch of K1.  The
    caller checked the operands; the layout is checked again here, where
    a saved program's run reaches the kernel without the wrapper."""
    global LAUNCHES
    check_layout({"x": x, "skip": skip})
    N, C, H, W = x.shape
    Cout = pw_w.shape[1]
    window = (0, H, 0, 2 * H) if window is None else window
    c0, c1 = window_rows(window, H)
    g = launch_geometry(N, c1 - c0, W, C, Cout, x.dtype)
    if g.grid[0] >= 2 ** 31 or g.grid[1] > _MAX_GRID_YZ:
        raise ValueError(f"K1's grid {g.grid} is too large for one launch")
    out = launch_stage("fd_fused_decoder_stage", "K1", x, dw_w, dw_b, pw_w, pw_b, skip,
                       window[3] - window[2], extra=(g.threads, g.tile_h, g.tile_w,
                                                     g.cout_tile, g.chunk, g.groups, *window))
    LAUNCHES += 1
    return out


def _stage_fake(x, dw_w, dw_b, pw_w, pw_b, skip, window):
    """The output's metadata, as :func:`launch_stage` allocates it."""
    rows = 2 * x.shape[2] if window is None else window[3] - window[2]
    return torch.empty((x.shape[0], pw_w.shape[1], rows, 2 * x.shape[3]), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


# K1 as the custom op fastdepth::fused_decoder_stage, registered when this
# module is imported: the plain version on the CPU, K1 on CUDA, and a fake
# (shapes, dtype and strides only) for torch.export's trace; no autograd
# (the TPU kernel has no VJP either).  LIBRARY must stay referenced: the
# registrations go with it.
LIBRARY = torch.library.Library("fastdepth", "FRAGMENT")
LIBRARY.define("fused_decoder_stage(Tensor x, Tensor dw_w, Tensor dw_b, Tensor pw_w, "
               "Tensor pw_b, Tensor? skip, int[]? window) -> Tensor")
LIBRARY.impl("fused_decoder_stage", _stage_cpu, "CPU")
LIBRARY.impl("fused_decoder_stage", _stage_cuda, "CUDA")
torch.library.register_fake("fastdepth::fused_decoder_stage", _stage_fake, lib=LIBRARY)
STAGE_OP = torch.ops.fastdepth.fused_decoder_stage.default
