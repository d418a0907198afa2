"""Every rank's tile of the ``space`` axis's sharded ops in one process, on
one device: the halo rules of ``parallel/spatial.py`` through the
device's own convolutions (cuDNN on a card).

A card runs a mesh at world size 1, whose space group holds every row,
so the sharded ops' tiles never reach cuDNN there, and two ranks on one
card are refused by NCCL.  Here the exchange itself is replaced: each
rank's partition holds the whole input (``Partition.whole``), so
``Level.halo`` and ``Level.gather`` read the rows a neighbour would send
out of it, and each rank's cropped, halo'd tile runs through the same op
code as on a real mesh, one rank after another.
``tests/test_torch_spatial.py`` holds this stand-in against the gloo
ranks' real exchange on the CPU (f64, 1e-12).

The op cases (:data:`OP_CASES`) are the zoo's halo rules: transposed
convs k = 3, 5, 7, 9 dense and depthwise, the ``-inf`` max pool, 7x7
and 1x1 stride-2 convs, bilinear x2, the zero-unpool and the pixel
shuffle, on levels that a space axis of 2 or 4 shards or replicates.
:func:`check` holds each tile against the unsharded op on the same
device: f32 within 1e-4 * max(1, max|unsharded|), the order of sums of
a cropped tile.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.parallel import spatial as S

# (case, op, kernel, depthwise, input rows, the partition's min_rows);
# each at S = 2 and 4, on levels sharded and replicated, into levels
# sharded and replicated
OP_BATCH, OP_C, OP_W = 2, 4, 6
OP_CASES = (
    [(f"tconv{k}{dw}-{r}", "tconv", k, bool(dw), r, 2)
     for k in (3, 5, 7, 9) for dw in ("", "dw") for r in (8, 4)]
    + [(f"{op}-{r}", op, k, False, r, 3)
       for op, k in (("maxpool", 3), ("conv7s2", 7), ("conv1s2", 1)) for r in (24, 16, 8)]
    + [(f"{op}-{r}", op, 0, False, r, 2) for op in ("bilinear", "unpool", "shuffle")
       for r in (8, 4)])
WORLDS = (2, 4)
F32_BOUND = 1e-4  # of max(1, max|unsharded|)


def op_operands(case, dtype: torch.dtype = torch.float64,
                device: Union[str, torch.device] = "cpu"):
    """(x, w, b) of an op case, seeded (drawn in f64 on the CPU, then cast
    and moved): ``x`` (N, C, rows, W) channels_last with its top two rows
    negative (a zero fill of the max pool's halo would show), the weights
    of a conv or transposed conv."""
    name, op, k, dw, rows, _ = case
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    x = torch.randn(OP_BATCH, OP_C, rows, OP_W, generator=g, dtype=torch.float64)
    x[:, :, :2] = -x[:, :, :2].abs() - 1
    w = b = None
    if op == "tconv":
        w = torch.randn(OP_C, 1 if dw else 3, k, k, generator=g, dtype=torch.float64)
        b = torch.randn(OP_C if dw else 3, generator=g, dtype=torch.float64)
    elif op.startswith("conv"):
        w = torch.randn(3, OP_C, k, k, generator=g, dtype=torch.float64)
        b = torch.randn(3, generator=g, dtype=torch.float64)
    x, w, b = (None if t is None else t.to(device=device, dtype=dtype) for t in (x, w, b))
    return x.contiguous(memory_format=torch.channels_last), w, b


def run_op(case, x: torch.Tensor, level=None) -> torch.Tensor:
    """The case's op of ``x``: its sharded form under ``level``, the
    unsharded op of ``ops/blocks.py`` without one (weights in ``x``'s
    dtype, on its device)."""
    _, op, k, dw, _, _ = case
    _, w, b = op_operands(case, x.dtype, x.device)
    if op == "tconv":
        kw = dict(stride=2, padding=(k - 1) // 2, output_padding=k % 2,
                  groups=OP_C if dw else 1)
        if level is None:
            return B.conv2d_transpose(x, w, bias=b, **kw)
        return S.conv_transpose2d(x, w, b, level=level, **kw)
    if op.startswith("conv"):
        if level is None:
            return B.conv2d(x, w, stride=2, bias=b)
        return S.conv2d(x, w, b, level=level, stride=2)
    plain = {"maxpool": S.max_pool_3x3_s2, "bilinear": S.upsample_bilinear2x,
             "unpool": S.unpool_zero, "shuffle": S.pixel_shuffle}[op]
    return plain(x, level)


def op_level(case, world: int, rank: int, rows: int,
             whole: Optional[torch.Tensor] = None) -> S.Level:
    """Rank ``rank``'s level of ``rows`` rows under the case's partition;
    with ``whole``, the level's halo rows and gather are read from it
    (``Partition.whole``) instead of exchanged."""
    return S.Level(S.Partition(world, rank, min_rows=case[5], whole=whole), rows)


def tiles(case, world: int, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's output rows of the case's sharded op of ``x`` over a
    ``world``-way space axis, rank after rank, each level's halo rows
    read from ``x`` (``Partition.whole``)."""
    out = []
    for rank in range(world):
        level = op_level(case, world, rank, x.shape[2], whole=x)
        out.append(run_op(case, level.take(x), level))
    return out


def check_case(case, world: int, device: Union[str, torch.device] = "cuda",
               dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The case at S = ``world`` on ``device``: every rank's tile against
    the unsharded op of the whole input, sliced to the rank's rows of the
    output level (all of a replicated one).  The worst |diff| over the
    ranks, the bound (f32: :data:`F32_BOUND` * max(1, max|unsharded|);
    f64: 1e-12), whether the input level is sharded, and ``ok`` (shapes
    equal, finite, within the bound)."""
    x = op_operands(case, dtype, device)[0]
    want = run_op(case, x)
    bound = (F32_BOUND if dtype == torch.float32 else 1e-12) * max(1.0, float(want.abs().max()))
    err, ok = 0.0, True
    for rank, y in enumerate(tiles(case, world, x)):
        lo, hi = op_level(case, world, rank, want.shape[2]).bounds()
        ref = want[:, :, lo:hi]
        if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
            ok = False
            continue
        err = max(err, float((y - ref).abs().max()))
    return {"case": case[0], "world": world, "max_abs_err": err, "bound": bound,
            "sharded": op_level(case, world, 0, x.shape[2]).sharded, "ok": ok and err <= bound}


def check(device: Union[str, torch.device] = "cuda",
          dtype: torch.dtype = torch.float32) -> List[Dict[str, object]]:
    """:func:`check_case` for every case at S = 2 and 4."""
    return [check_case(case, world, device, dtype) for case in OP_CASES for world in WORLDS]


def misses(rows) -> List[str]:
    """The (case, S) names of :func:`check`'s rows that failed."""
    return [f"{r['case']}@S={r['world']}" for r in rows if not r["ok"]]

