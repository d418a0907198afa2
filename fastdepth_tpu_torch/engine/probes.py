"""The probe catalogue: every Pallas probe of the JAX package's ``scripts/``,
by the tag the script printed, with its inputs, its kernel call on the
card and its plain call.

The TPU probes (``scripts/bisect_v3.py``, ``bisect_v3c.py``,
``bisect_v3d.py``, ``bisect_v3e.py`` and ``probe_xla_opts.py::dma_copy``)
checked which manual-DMA staging patterns compiled and what they moved.
Each entry here runs the same function on the same inputs through the
port's kernel (K5 :func:`~fastdepth_tpu_torch.ops.cuda.probes.staged_copy`,
K6 :func:`~fastdepth_tpu_torch.ops.cuda.probes.staged_compute`, or K3 for
the probes that ran the v3 stage) and through its plain PyTorch version.

Inputs are the scripts' own: each script drew from one shared
``np.random.RandomState(0)``, probe after probe, and :func:`inputs`
replays that stream (draws of other probes are skipped, not kept) and
casts as the script cast (f32; bf16 through f32).  Outputs come back in
the script's layout (NHWC, or the flat and folded shapes).  The scripts'
one program walked the images in order on a one-core TPU, which was the
whole chip: every probe here runs on the whole card (no tag pins K5's
grid).  Where one PyTorch call computes a probe's function, the entry
names it as its yardstick (``library``; never called by the port).

:func:`copy_sweep` is the bandwidth sweep of ``dma_copy``: K5 as a pure
copy at the script's 32 MB and at 256 MB, over chunk sizes that fit in
shared memory (:data:`SWEEP_CHUNKS`).  Read and write of 32 MB (64 MB of
traffic) partly stay in the H100's 50 MB L2; only the 256 MB reading is
the device memory's ceiling.  :func:`compute_sweep` runs each K6 mode
once at a scale where its bound is well above a launch's cost
(:data:`SCALE_ROWS`).  Both stay outside the catalogue, which mirrors
the scripts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import probes as KP
from fastdepth_tpu_torch.ops.cuda.fused_decoder import fused_decoder_stage_reference
from fastdepth_tpu_torch.ops.cuda.fused_decoder_v3 import fused_decoder_stage_v3

Device = Union[str, torch.device]

# dma_copy's chunk_rows of 1024 f32 lanes (256 KB to 16 MB, for VMEM) ->
# K5's bytes per slot: the script's two slots must fit in the 227 KB of
# shared memory a block can use, so each size maps to the nearest that does
SWEEP_CHUNKS = {64: 8 << 10, 256: 32 << 10, 1024: 64 << 10, 4096: 112 << 10}
SWEEP_SIZES = (32 << 20, 256 << 20)
L2_NOTE = ("32 MB read + 32 MB written partly stay in the H100's 50 MB L2; "
           "only the 256 MB rows read the device memory's ceiling")
# K6 at a scale whose bound is far above a launch's cost: (mode, x shape,
# Cout).  The matmul modes at the pruned flagship's decoder level 1
# pointwise at batch 128 (1.28 GFLOP); taps and up_only on a 28x28x256
# map at batch 128 (bytes-bound)
SCALE_ROWS = (("matmul", (128, 7, 7, 512), 200), ("matmul_up", (128, 7, 7, 512), 200),
              ("taps", (128, 28, 28, 256), 256), ("up_only", (128, 28, 28, 256), 256))


# --- the scripts' random streams ----------------------------------------

# Per script, its draws in order: (probe group, name, shape, scale), each
# rng.rand(*shape) * scale.  "-" marks draws no probe here uses.
_V3E_STAGE = [("x", (32, 56, 56, 128), 1.0), ("dw_w", (5, 5, 1, 128), 0.1),
              ("dw_b", (128,), 0.1), ("pw_w", (1, 1, 128, 128), 0.1),
              ("pw_b", (128,), 0.1), ("skip", (32, 112, 112, 128), 1.0)]
_V3C_RUNS = [("matmul_128to64", 128, 64), ("matmul_128to128", 128, 128),
             ("matmul_up_128to64", 128, 64), ("taps_120", 120, 120), ("up_only_64", 64, 64),
             ("matmul_120to56", 120, 56), ("matmul_128to256", 128, 256)]
STREAMS = {
    "scripts/bisect_v3.py": [("v3", "x", (4, 8, 8, 128), 1.0)],
    "scripts/bisect_v3c.py": [d for tag, c, co in _V3C_RUNS
                              for d in ((tag, "x", (4, 8, 8, c), 1.0),
                                        (tag, "w", (c, co), 0.1))],
    "scripts/bisect_v3d.py": [
        ("matmul_192to192", "x", (4, 8, 8, 192), 1.0), ("matmul_192to192", "w", (192, 192), 0.1),
        ("matmul_256to120", "x", (4, 8, 8, 256), 1.0), ("matmul_256to120", "w", (256, 120), 0.1),
        ("flat_dma_C64_hwc4096", "x", (4, 8, 8, 64), 1.0),
        ("flat_dma_C56_hwc3584", "x", (4, 8, 8, 56), 1.0),
        ("flat_dma_C200_hw14_39200", "x", (4, 14, 14, 200), 1.0),
        ("vmem_autocopy_C64", "x", (4, 8, 8, 64), 1.0),
        ("dma_2d_C64", "x", (4, 64, 64), 1.0)],
    "scripts/bisect_v3e.py": (
        [("v3_s4like", n, s, k) for n, s, k in _V3E_STAGE]
        # the f32 parity check: the same draws at N = 4
        + [("onchip_parity", n, (4,) + s[1:] if s[0] == 32 else s, k) for n, s, k in _V3E_STAGE]
        + [("rank3_folded_dma_7168", "x", (4, 56, 7168), 1.0),
           ("value_reshape_split", "x", (4, 56, 7168), 1.0)]),
    "scripts/probe_xla_opts.py": (
        [("-", "x128", (128, 224, 224, 3), 1.0), ("-", "x4", (4, 224, 224, 3), 1.0),
         ("-", "xb256", (256, 224, 224, 3), 1.0), ("-", "xb512", (512, 224, 224, 3), 1.0)]
        + [(f"dma_copy_chunk{rows}", "x", (8192, 1024), 1.0) for rows in SWEEP_CHUNKS]),
}


_PIECE = 1 << 22  # doubles drawn at a time, to bound the memory


def _draw(rng: np.random.RandomState, shape, scale: float) -> np.ndarray:
    """``(rng.rand(*shape) * scale).astype(float32)``, drawn in pieces (the
    stream is the same)."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)
    for i in range(0, n, _PIECE):
        k = min(_PIECE, n - i)
        out[i:i + k] = rng.random_sample(k) * scale
    return out.reshape(shape)


@functools.lru_cache(maxsize=None)
def _states(script: str) -> Dict[str, tuple]:
    """The script's RandomState(0) state at each group's first draw."""
    rng = np.random.RandomState(0)
    states = {}
    for g, _, shape, _ in STREAMS[script]:
        states.setdefault(g, rng.get_state())
        for i in range(0, int(np.prod(shape)), _PIECE):
            rng.random_sample(min(_PIECE, int(np.prod(shape)) - i))
    return states


def script_arrays(script: str, group: str) -> Dict[str, np.ndarray]:
    """The group's draws as the script made them: ``rng.rand * scale``,
    cast to float32 as its ``jnp.asarray(..., jnp.float32)``."""
    rng = np.random.RandomState(0)
    rng.set_state(_states(script)[group])
    return {name: _draw(rng, shape, scale)
            for g, name, shape, scale in STREAMS[script] if g == group}


# --- the catalogue -----------------------------------------------------

Args = Tuple[Optional[torch.Tensor], ...]


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: ``kernel(*args)`` and ``plain(*args)`` compute the same
    function; ``exact`` probes (the copies, nearest x2 and taps, whose
    kernel rounds and adds its 25 products in the plain version's order)
    must agree bit for bit."""

    tag: str
    script: str
    replaces: str  # file:line of the TPU function
    kernel_name: str  # K3, K5 or K6
    group: str
    make_args: Callable[[Dict[str, np.ndarray], torch.device], Args]
    kernel: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    exact: bool
    dtype: torch.dtype = torch.float32
    # one PyTorch call computing the same function on the same inputs,
    # where there is one (the yardstick chip_smoke.py times as library_ms)
    library: Optional[Callable[..., torch.Tensor]] = None
    mode: str = "copy"  # copy (K5), a K6 mode, or stage (K3): what work() counts


def _t(a: np.ndarray, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    # the script's f32 draws (bf16 is rounded from them)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def _copy_probe(tag, script, line, group, view, *, scale=2.0, depth=1, prefetch=False,
                bcast_c0=False, chunk_bytes=None):
    """A K5 probe: ``view(x)`` is the array as K5 sees it (a row per
    image, or the whole array as one row); the result takes ``x``'s shape."""
    kw = dict(scale=scale, depth=depth, prefetch=prefetch, bcast_c0=bcast_c0,
              chunk_bytes=chunk_bytes)
    if bcast_c0:
        def library(x):
            v = view(x)  # a view: no work
            return torch.add(v[..., :1], v, alpha=scale)
    else:
        def library(x):
            return torch.mul(x, scale)
    return Probe(
        tag, script, f"{script}:{line}", "K5", group,
        lambda a, dev: (_t(a["x"], dev),),
        lambda x: KP.staged_copy(view(x), **kw).reshape(x.shape),
        lambda x: KP.staged_copy_reference(view(x), scale, bcast_c0).reshape(x.shape),
        exact=True, library=library, mode="copy_bcast" if bcast_c0 else "copy")


@functools.lru_cache(maxsize=None)
def _tap_filter(C: int, device: torch.device) -> torch.Tensor:
    """taps' depthwise 5x5 filter, every tap 0.04, built once per width and
    device (outside any timed call)."""
    return torch.full((C, 1, 5, 5), KP.TAP_SCALE, device=device)


def _taps_library(x, w=None):
    """taps as one depthwise conv on the NHWC tensor's channels_last view
    (the same function up to the order of its 25-term sums)."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), _tap_filter(C, x.device), padding=2, groups=C)
    return y.permute(0, 2, 3, 1)


def _up_library(x, w=None):
    """up_only as one nearest x2 on the channels_last view, returned as
    NHWC through a view (no copy); bit-exact."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="nearest").permute(0, 2, 3, 1)


# K6's one-call yardstick per mode.  matmul_up has none: a product and an
# upsample are two calls
LIBRARY = {"matmul": lambda x, w: torch.matmul(x, w), "matmul_up": None,
           "taps": _taps_library, "up_only": _up_library}


def _compute_probe(tag, script, line, group, mode):
    matmul = mode in ("matmul", "matmul_up")
    return Probe(
        tag, script, f"{script}:{line}", "K6", group,
        lambda a, dev: (_t(a["x"], dev), _t(a["w"], dev) if matmul else None),
        lambda x, w: KP.staged_compute(x, w, mode),
        lambda x, w: KP.staged_compute_reference(x, w, mode),
        exact=mode in ("taps", "up_only"), library=LIBRARY[mode], mode=mode)


def _stage_args(a, dev, dtype, skip: bool, weights=None):
    """K3's operands from the script's NHWC/HWIO arrays (or the given
    (dw_w, dw_b, pw_w, pw_b) in K3's layout)."""
    x = TB.from_nhwc(_t(a["x"], dev, dtype))
    C = x.shape[1]
    if weights is None:
        weights = (_t(a["dw_w"].reshape(25, C), dev, dtype), _t(a["dw_b"], dev, dtype),
                   _t(a["pw_w"].reshape(C, -1), dev, dtype), _t(a["pw_b"], dev, dtype))
    sk = TB.from_nhwc(_t(a["skip"], dev, dtype)) if skip else None
    return (x, *weights, sk)


def _stage_probe(tag, script, line, group, make_args, dtype):
    return Probe(
        tag, script, f"{script}:{line}", "K3", group, make_args,
        lambda *ops: TB.to_nhwc(fused_decoder_stage_v3(*ops, block_batch=1)).contiguous(),
        lambda *ops: TB.to_nhwc(fused_decoder_stage_reference(*ops)).contiguous(),
        exact=False, dtype=dtype, mode="stage")


def _e_args(a, dev):
    """bisect_v3.py k_e's stage: dw taps 0.1, dw bias 0, pw = I, pw bias 0."""
    C = a["x"].shape[-1]
    f = torch.float32
    weights = (torch.full((25, C), 0.1, dtype=f, device=dev), torch.zeros(C, dtype=f, device=dev),
               torch.eye(C, dtype=f, device=dev), torch.zeros(C, dtype=f, device=dev))
    return _stage_args(a, dev, f, skip=False, weights=weights)


def _whole(x):
    return x.reshape(1, -1)


def _images(x):
    return x.reshape(x.shape[0], -1)


def _pixels(x):
    # (n, h, w*c) -> (n, h, w, c): value_reshape_split's lane split, c = 128
    return x.reshape(*x.shape[:-1], x.shape[-1] // 128, 128)


_V3 = "scripts/bisect_v3.py"
_V3C = "scripts/bisect_v3c.py"
_V3D = "scripts/bisect_v3d.py"
_V3E = "scripts/bisect_v3e.py"
_XLA = "scripts/probe_xla_opts.py"

_LIST: List[Probe] = [
    # bisect_v3.py: the v3 skeleton, construct by construct (via run, :27/:30)
    _copy_probe("A_static_dma", _V3, 48, "v3", _whole),
    _copy_probe("B_loop_static_slot", _V3, 64, "v3", _images),
    _copy_probe("C_dynamic_slot", _V3, 83, "v3", _images, depth=2),
    _copy_probe("D_double_buffer", _V3, 103, "v3", _images, depth=2, prefetch=True),
    _stage_probe("E_full_compute", _V3, 148, "v3", _e_args, torch.float32),
    # bisect_v3c.py: make_kernel's modes (via run, :72/:77)
    *[_compute_probe(tag, _V3C, 26, tag, tag.rsplit("_", 1)[0]) for tag, _, _ in _V3C_RUNS],
    # bisect_v3d.py
    _compute_probe("matmul_192to192", _V3D, 38, "matmul_192to192", "matmul"),
    _compute_probe("matmul_256to120", _V3D, 38, "matmul_256to120", "matmul"),
    *[_copy_probe(tag, _V3D, 71, tag, _images) for tag in
      ("flat_dma_C64_hwc4096", "flat_dma_C56_hwc3584", "flat_dma_C200_hw14_39200")],
    _copy_probe("vmem_autocopy_C64", _V3D, 103, "vmem_autocopy_C64", _whole),
    _copy_probe("dma_2d_C64", _V3D, 121, "dma_2d_C64", _images),
    # bisect_v3e.py: the v3 stage at an s4-like shape (bf16, :44-54), its
    # f32 parity check (:56-71), and the two folded-lane copies
    _stage_probe("v3_s4like_C128_skip", _V3E, 47, "v3_s4like",
                 lambda a, dev: _stage_args(a, dev, torch.bfloat16, skip=True), torch.bfloat16),
    _stage_probe("v3_s4like_C128_noskip", _V3E, 47, "v3_s4like",
                 lambda a, dev: _stage_args(a, dev, torch.bfloat16, skip=False), torch.bfloat16),
    _stage_probe("onchip_parity", _V3E, 67, "onchip_parity",
                 lambda a, dev: _stage_args(a, dev, torch.float32, skip=True), torch.float32),
    _copy_probe("rank3_folded_dma_7168", _V3E, 95, "rank3_folded_dma_7168", _images),
    _copy_probe("value_reshape_split", _V3E, 124, "value_reshape_split", _pixels,
                bcast_c0=True),
    # probe_xla_opts.py dma_copy: two slots, each copy waited, one pure copy
    *[_copy_probe(f"dma_copy_chunk{rows}", _XLA, 156, f"dma_copy_chunk{rows}", _whole,
                  scale=1.0, depth=2, chunk_bytes=nbytes)
      for rows, nbytes in SWEEP_CHUNKS.items()],
]
PROBES: Dict[str, Probe] = {p.tag: p for p in _LIST}


def replaces(kernel_name: str) -> str:
    """The TPU functions a kernel stands in for across the catalogue, as
    ``script:line,line; script:line`` in catalogue order."""
    lines: Dict[str, List[str]] = {}
    for p in PROBES.values():
        if p.kernel_name == kernel_name:
            script, line = p.replaces.split(":")
            if line not in lines.setdefault(script, []):
                lines[script].append(line)
    return "; ".join(f"{s}:{','.join(ls)}" for s, ls in lines.items())


def inputs(tag: str, device: Device = "cuda") -> Args:
    """The probe's operands on ``device``, from the script's stream."""
    p = PROBES[tag]
    return p.make_args(script_arrays(p.script, p.group), torch.device(device))


@torch.inference_mode()
def run(tag: str, device: Device = "cuda", args: Optional[Args] = None) -> torch.Tensor:
    """The probe's kernel output (on the CPU, the wrappers' plain version)."""
    return PROBES[tag].kernel(*(args if args is not None else inputs(tag, device)))


@torch.inference_mode()
def run_plain(tag: str, device: Device = "cuda", args: Optional[Args] = None) -> torch.Tensor:
    """The probe's plain PyTorch output."""
    return PROBES[tag].plain(*(args if args is not None else inputs(tag, device)))


def work(tag: str, args: Args, out: torch.Tensor) -> Tuple[int, int, int]:
    """(bytes, CUDA-core FLOPs, tensor-core FLOPs) of one call: every
    operand read once and the output written once; the arithmetic of the
    probe's function (f32 on the CUDA cores; K3's bf16 stage puts its
    pointwise on the tensor cores' count)."""
    p = PROBES[tag]
    return mode_work(p.mode, args, out, p.dtype)


def mode_work(mode: str, args: Args, out: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """:func:`work` by the probe's ``mode`` (copy, copy_bcast, a K6 mode or
    stage) rather than its tag."""
    nbytes = sum(a.numel() * a.element_size() for a in args if a is not None)
    nbytes += out.numel() * out.element_size()
    x = args[0]
    if mode.startswith("copy"):
        return nbytes, x.numel() * (2 if mode == "copy_bcast" else 1), 0
    if mode in ("matmul", "matmul_up"):
        return nbytes, 2 * x.numel() * args[1].shape[-1], 0
    if mode == "taps":
        return nbytes, 50 * x.numel(), 0
    if mode == "up_only":
        return nbytes, 0, 0
    px = x.shape[0] * x.shape[2] * x.shape[3]  # K3's stage: x (N, C, H, W)
    dw, pw = 52 * px * x.shape[1], 2 * px * x.shape[1] * args[3].shape[1]
    return (nbytes, dw + pw, 0) if dtype == torch.float32 else (nbytes, dw, pw)


def bound(tag: str, plain: torch.Tensor) -> float:
    """The largest max|kernel - plain| the probe allows: 0 for the copies;
    1e-4 * max(1, max|plain|) in f32 (summation order only); 2^-7 *
    max|plain| in bf16 (one rounding of the output)."""
    p = PROBES[tag]
    if p.exact:
        return 0.0
    scale = float(plain.float().abs().max())
    return 1e-4 * max(1.0, scale) if p.dtype == torch.float32 else 2.0 ** -7 * scale


def copy_sweep(device: Device = "cuda", sizes: Sequence[int] = SWEEP_SIZES, *,
               calls: int = 20) -> List[dict]:
    """K5 as a pure copy (scale 1) of ``sizes`` bytes, one row cut into
    :data:`SWEEP_CHUNKS`, two slots, prefetch off and on, on the full
    card: GB/s = 2 * bytes / time, by device time (a CUDA graph of the
    calls) and by CUDA events around pipelined calls.  Each row names its
    script chunk_rows; ``hbm_ceiling`` marks the 256 MB rows, the only
    ones that read the device memory's ceiling (:data:`L2_NOTE`).  Needs
    a CUDA device."""
    from fastdepth_tpu_torch.engine.benchmark import time_graph, time_pipelined

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the copy sweep measures the card: it needs a CUDA device")
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for nbytes in sizes:
        # one f32 row; a copy's time does not depend on the values
        x = torch.rand((1, nbytes // 4), generator=gen, device=device)
        for script_rows, chunk in SWEEP_CHUNKS.items():
            for pf in (False, True):
                fn = functools.partial(KP.staged_copy, scale=1.0, chunk_bytes=chunk, depth=2,
                                       prefetch=pf)
                with torch.inference_mode():
                    if not torch.equal(fn(x), x):
                        raise RuntimeError(f"K5's copy of {nbytes} bytes is not the input")
                    dev_s = time_graph(fn, [(x,)], calls=calls)
                    ev_s = time_pipelined(fn, (x,), calls=calls, device=device)["mean_s"]
                rows.append({
                    "bytes": nbytes, "chunk_bytes": chunk, "script_chunk_rows": script_rows,
                    "prefetch": pf, "device_us": dev_s * 1e6, "events_us": ev_s * 1e6,
                    "GBs": 2 * nbytes / dev_s / 1e9, "GBs_events": 2 * nbytes / ev_s / 1e9,
                    "hbm_ceiling": nbytes >= 256 << 20})
        del x
    return rows


def compute_sweep(device: Device = "cuda", *, calls: int = 20) -> List[dict]:
    """K6 at :data:`SCALE_ROWS`, each mode once: seeded inputs (x uniform in
    [0, 1), w in [0, 0.1) as the scripts drew them), the kernel held
    against its plain version (1e-4 * max(1, max|plain|); taps and up_only
    bit for bit) and timed L2-cold (``engine/benchmark.time_graph`` over
    ``cold_copies`` sets) beside the plain version, the mode's one-call
    yardstick (:data:`LIBRARY`, where there is one) and its bound.  Needs
    a CUDA device."""
    from fastdepth_tpu_torch.engine.benchmark import bound_us, cold_copies, time_graph

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the compute sweep measures the card: it needs a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    out_rows = []
    for mode, shape, cout in SCALE_ROWS:
        x = torch.rand(shape, generator=gen, device=device)
        w = (torch.rand((shape[-1], cout), generator=gen, device=device) * 0.1
             if mode in ("matmul", "matmul_up") else None)
        with torch.inference_mode():
            got = KP.staged_compute(x, w, mode)
            want = KP.staged_compute_reference(x, w, mode)
            err = float((got - want).abs().max())
            tol = (0.0 if mode in ("taps", "up_only")
                   else 1e-4 * max(1.0, float(want.abs().max())))
            nbytes, core, tensor = mode_work(mode, (x, w), want)
            sets = [(x, w)] + [(x.clone(), w) for _ in range(cold_copies(nbytes) - 1)]
            row = {"mode": mode, "shape": list(shape), "Cout": cout, "max_abs_err": err,
                   "tol": tol, "ok": bool(err <= tol and torch.isfinite(got).all())}
            del got, want
            row["bound_us"], row["bound_by"] = bound_us(nbytes, core, tensor)
            for key, fn in (("", lambda a, b: KP.staged_compute(a, b, mode)),
                            ("plain_", lambda a, b: KP.staged_compute_reference(a, b, mode)),
                            ("library_", LIBRARY[mode])):
                if fn is not None:
                    row[f"{key}device_us"] = time_graph(fn, sets, calls=calls) * 1e6
        row["share_of_bound"] = row["bound_us"] / row["device_us"]
        out_rows.append(row)
        del x, w, sets
    return out_rows
