"""Height sharding for the mesh's ``space`` axis: which rows each rank
holds at each level of a forward, and the halo exchange between ranks.

The JAX package gave XLA's SPMD partitioner a height-sharded activation
and let it exchange every op's halo rows (``fastdepth_tpu/parallel/
mesh.py``).  Eager PyTorch does neither, so this module owns both, for
every depth model of the registry (:func:`supports`):

* **The row partition.**  A level of ``rows`` rows is *sharded* when it
  splits into S equal shards of at least ``Partition.min_rows`` rows,
  the widest halo the model's ops need (:func:`min_rows`: 2 for the
  MobileNet + NNConv5 family's 5x5, 3 for ResNet's 7x7 stem and the
  7x7 decoders, 4 for the 9x9 ones), so that a halo always comes from
  one neighbour; rank s of the space group then holds rows
  ``[s rows / S, (s + 1) rows / S)``.  Otherwise the level is computed
  *replicated*, whole on every rank of the group, and a rank slices its
  rows back out where the next level is sharded again (:meth:`Level.
  take`).  Halving keeps the rule monotone: a sharded level's double is
  sharded, a replicated level's half replicated.  At 224^2 and S = 2 the
  flagship's levels 224 ... 14 are sharded and 7 is replicated; at S = 8
  the levels 28 and below.  Replicated compute is exact (the same rows
  on every rank) and costs each rank the whole of those small levels.
* **The exchange.**  :meth:`Level.halo` gives a rank's rows the rows
  above and below it that a window reads: from the neighbours over the
  space group with ``dist.batch_isend_irecv`` (point-to-point, which
  NCCL and gloo both carry), rows of a fill value at the image's top and
  bottom (zeros for a conv, ``-inf`` for the max pool); a negative halo
  crops the rank's own rows (a 1x1 stride-2 conv reads none of its last
  row).  A partition that holds its level's ``whole`` tensor reads the
  neighbours' rows out of it instead, so one process can run every
  rank's tile in turn (``parallel/halo_check.py``).
* **The ops.**  :func:`conv2d` runs a k x k conv of a sharded level as
  an exchange, then ``F.conv2d`` with no padding along the height on the
  halo'd tile (cuDNN on the card, as the unsharded path); a pointwise
  conv needs no halo; an op from a sharded level into a replicated one
  gathers its input first.  :func:`max_pool_3x3_s2`,
  :func:`conv_transpose2d` and :func:`upsample_bilinear2x` exchange
  their own halos; :func:`upsample_nearest2x`, :func:`unpool_zero` and
  :func:`pixel_shuffle` are local.  :func:`k1_window` gives K1 its tile
  and row window (``ops/cuda/fused_decoder.py``).
* **World size 1.**  A space group of one rank holds every row: every
  helper here is then the unsharded call itself, so a one-card mesh runs
  exactly the forward without a mesh.

Only forwards: the port has no halo backward (``train/trainer.py``
refuses a ``space`` axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fastdepth_tpu_torch.ops import blocks as B

# the fewest rows a shard holds: the widest halo of the MobileNet +
# NNConv{3,5} family, the decoder's 5x5 (the encoder's 3x3 needs 1 row);
# other models need more (min_rows)
MIN_ROWS = 2


def _transpose_halo(k: int, stride: int, p: int) -> Tuple[int, int]:
    """(above, below): the input rows past a rank's own ``[lo, hi)`` that a
    k x k transposed conv of ``stride`` and padding ``p`` reads for the
    output rows ``[stride lo, stride hi)`` (output row o reads input row
    i where o = stride i - p + t, 0 <= t < k)."""
    return (k - 1 - p) // stride, (stride - 1 + p) // stride


def min_rows(cfg) -> int:
    """The fewest rows a shard of a forward of ``cfg`` may hold: the
    widest halo its ops exchange, and at least :data:`MIN_ROWS` (so the
    MobileNet + NNConv5 family keeps its partition and K1 windows).
    ResNet's 7x7 s2 p3 stem reads 3 rows above a rank's and 2 below; a
    k x k conv (k - 1) / 2 each side; a transposed conv at most 2
    (:func:`_transpose_halo`); the max pool and bilinear x2 1."""
    name = cfg.decoder.removesuffix("dw")
    if name in ("upconv", "upproj") or (cfg.skip and cfg.encoder != "mobilenet"):
        k = 5  # UpConv, UpProj and ResNet's skip decoders: 5x5 convs
    else:
        k = int(name[-1])
    if name.startswith("deconv"):
        rows = max(_transpose_halo(k, 2, (k - 1) // 2))
    else:
        rows = (k - 1) // 2
    if cfg.encoder.startswith("resnet"):
        rows = max(rows, 3)  # the stem
    return max(MIN_ROWS, rows)


@dataclasses.dataclass(frozen=True)
class Partition:
    """One rank's place on the space axis: the group's ``size`` S, this
    rank's ``rank`` s in it, the group, and the group's global ranks in
    space order (point-to-point peers are named by global rank), and the
    fewest rows a shard of a level holds (a model's :func:`min_rows`).
    ``whole``, where given, is the whole of the level whose halo rows and
    gather it stands in for: no exchange then, the rows are read from it
    (:meth:`Level.halo`)."""

    size: int
    rank: int
    group: Any = None
    ranks: Tuple[int, ...] = (0,)
    min_rows: int = MIN_ROWS  # the fewest rows a shard holds (min_rows(cfg))
    whole: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False, repr=False)

    def sharded(self, rows: int) -> bool:
        """True when a level of ``rows`` rows is split over the group."""
        return (self.size > 1 and rows % self.size == 0
                and rows // self.size >= self.min_rows)

    def bounds(self, rows: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a level (all of a replicated one)."""
        if not self.sharded(rows):
            return 0, rows
        k = rows // self.size
        return self.rank * k, (self.rank + 1) * k

    def level(self, rows: int) -> "Level":
        return Level(self, rows)


@dataclasses.dataclass(frozen=True)
class Level:
    """A map of ``rows`` global rows under partition ``part``; the tensor
    that goes with it holds :meth:`bounds` of them (NCHW, rows on dim 2)."""

    part: Partition
    rows: int

    @property
    def sharded(self) -> bool:
        return self.part.sharded(self.rows)

    def bounds(self) -> Tuple[int, int]:
        return self.part.bounds(self.rows)

    def down(self, k: int = 3, stride: int = 2, padding: Optional[int] = None) -> "Level":
        """The level a k x k conv of ``stride`` (pad (k - 1) / 2) gives."""
        p = (k - 1) // 2 if padding is None else padding
        return Level(self.part, (self.rows + 2 * p - k) // stride + 1)

    def up(self) -> "Level":
        """The level a x2 upsample gives."""
        return Level(self.part, 2 * self.rows)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor that holds the whole level (the
        tensor itself where the level is replicated)."""
        if not self.sharded:
            return x
        lo, hi = self.bounds()
        return x.narrow(2, lo, hi - lo)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole level from every rank's rows (an all-gather over the
        space group, or the partition's ``whole``; the tensor itself where
        the level is replicated)."""
        if not self.sharded:
            return x
        if self.part.whole is not None:
            return _like(self._whole(), x)
        t = x.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.part.size)]
        dist.all_gather(parts, t, group=self.part.group)
        return _like(torch.cat(parts, 2), x)

    def halo(self, x: torch.Tensor, above: int, below: int, fill: float = 0.0) -> torch.Tensor:
        """This rank's rows with ``above`` rows of the rank before and
        ``below`` of the rank after (rows of ``fill`` at the image's top
        and bottom): a sharded level only, whose shards hold at least as
        many rows as either halo.  A negative halo drops that many of
        the rank's own rows on its side instead."""
        lo, hi = self.bounds()
        if not self.sharded or max(above, below) > hi - lo:
            raise ValueError(f"a halo of {above} + {below} rows needs a level sharded into "
                             f"shards of at least that many rows; got {self.rows} rows over "
                             f"{self.part.size} ranks")
        n, c, h, w = x.shape
        top = x.new_full((n, c, above, w), fill) if above > 0 else None
        bottom = x.new_full((n, c, below, w), fill) if below > 0 else None
        if self.part.whole is not None:
            self._read(top, bottom)
        else:
            self._exchange(x, top, bottom)
        crop_top, crop_bottom = max(-above, 0), max(-below, 0)
        own = x.narrow(2, crop_top, h - crop_top - crop_bottom)
        return _like(torch.cat([t for t in (top, own, bottom) if t is not None], 2), x)

    def _exchange(self, x: torch.Tensor, top: Optional[torch.Tensor],
                  bottom: Optional[torch.Tensor]) -> None:
        """Receive ``top`` from the rank before and ``bottom`` from the rank
        after over the space group, sending them this rank's edge rows
        (the image's edges keep their fill)."""
        part, s, h = self.part, self.part.rank, x.shape[2]
        ops = []
        if top is not None:
            if s > 0:
                ops.append(dist.P2POp(dist.irecv, top, part.ranks[s - 1], part.group))
            if s < part.size - 1:
                ops.append(dist.P2POp(dist.isend, x[:, :, h - top.shape[2]:].contiguous(),
                                      part.ranks[s + 1], part.group))
        if bottom is not None:
            if s < part.size - 1:
                ops.append(dist.P2POp(dist.irecv, bottom, part.ranks[s + 1], part.group))
            if s > 0:
                ops.append(dist.P2POp(dist.isend, x[:, :, :bottom.shape[2]].contiguous(),
                                      part.ranks[s - 1], part.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _read(self, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor]) -> None:
        """``top`` and ``bottom`` copied from the partition's ``whole``: the
        rows the neighbours would send (the image's edges keep their
        fill)."""
        whole = self._whole()
        lo, hi = self.bounds()
        if top is not None and lo > 0:
            top.copy_(whole[:, :, lo - top.shape[2]:lo])
        if bottom is not None and hi < self.rows:
            bottom.copy_(whole[:, :, hi:hi + bottom.shape[2]])

    def _whole(self) -> torch.Tensor:
        whole = self.part.whole
        if whole.shape[2] != self.rows:
            raise ValueError(f"the partition holds a {whole.shape[2]}-row level, "
                             f"not this {self.rows}-row one")
        return whole


def supports(cfg) -> bool:
    """True when a height-sharded forward covers the architecture: every
    depth model of the registry (a MobileNet or ResNet encoder with any
    decoder, skips or not)."""
    return cfg.encoder == "mobilenet" or cfg.encoder.startswith("resnet")


def check_model(cfg) -> None:
    """Refuse a model the height-sharded forward does not cover."""
    if not supports(cfg):
        raise ValueError(f"the 'space' mesh axis shards the depth models of the registry "
                         f"(a mobilenet or resnet encoder); got encoder={cfg.encoder!r}")


def input_level(part: Optional[Partition], x: torch.Tensor, cfg) -> Optional[Level]:
    """The level of a height-sharded forward's NHWC input ``x`` (this
    rank's even share of the image's rows) under ``part``, whose shards
    hold at least the model's :func:`min_rows`; None without one.  The
    image's level must be sharded (rows divisible by S, at least
    ``min_rows(cfg)`` a rank), so the output splits as the input did."""
    if part is None:
        return None
    check_model(cfg)
    part = dataclasses.replace(part, min_rows=min_rows(cfg))
    level = Level(part, x.shape[1] * part.size)
    if part.size > 1 and not level.sharded:
        raise ValueError(f"a {level.rows}-row image does not split into {part.size} shards "
                         f"of at least {part.min_rows} rows, the widest halo of "
                         f"encoder={cfg.encoder!r} decoder={cfg.decoder!r}")
    return level


def upsample(x: torch.Tensor, level: Optional[Level]):
    """(nearest x2 of ``x``, its level): :func:`upsample_nearest2x` under a
    level, the plain upsample without (level None)."""
    if level is None:
        return F.interpolate(x, scale_factor=2, mode="nearest"), None
    return upsample_nearest2x(x, level), level.up()


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s memory format (the port's activations are
    channels_last)."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _windowed(op, x: torch.Tensor, level: Level, k: int, stride: int, p: int,
              fill: float = 0.0) -> torch.Tensor:
    """``op(x, padding)``, a k x k window op of ``stride`` and padding p
    (``padding`` p, or ``(0, p)`` on a halo'd tile), of the whole level,
    as this rank's rows of the output level.  Output rows ``[olo, ohi)``
    read input rows ``stride olo - p .. stride (ohi - 1) - p + k - 1``:
    with a sharded input and output the halo is what that range reaches
    past the rank's rows (3x3, stride 2 on even shards: one row above and
    none below; 1x1 stride 2: none above, and one of its own rows fewer
    below), exchanged with ``fill`` past the image's edges, then the op
    runs with no padding along the height.  A replicated input gives the
    replicated output, sliced; a sharded input into a replicated output
    is gathered first."""
    out = level.down(k, stride, p)
    if level.part.size == 1:
        return op(x, p)
    if not level.sharded:
        return out.take(op(x, p))
    if not out.sharded:
        return op(level.gather(x), p)
    lo, hi = level.bounds()
    olo, ohi = out.bounds()
    above, below = lo - (stride * olo - p), stride * (ohi - 1) - p + k - hi
    return op(level.halo(x, above, below, fill), (0, p))


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], *, level: Level,
           stride: int = 1, padding: Optional[int] = None, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, bias, stride, padding, groups=groups)`` of the
    whole level, as this rank's rows of the output level (a square OIHW
    kernel, ``padding`` None for (k - 1) / 2; :func:`_windowed`).  A
    pointwise stride-1 conv needs no halo."""
    k = w.shape[-1]
    p = (k - 1) // 2 if padding is None else padding
    if k == 1 and stride == 1 and p == 0:
        return F.conv2d(x, w, bias, stride=stride, padding=p, groups=groups)
    return _windowed(lambda t, pad: F.conv2d(t, w, bias, stride=stride, padding=pad,
                                             groups=groups), x, level, k, stride, p)


def max_pool_3x3_s2(x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """``MaxPool2d(3, stride=2, padding=1)`` (ResNet's stem pool) of the
    whole level as this rank's rows of the next one: one halo row above
    and none below on even shards, ``-inf`` past the image's top, as the
    pool's own padding counts.  ``level`` None: the unsharded pool."""
    if level is None:
        return B.max_pool_3x3_s2(x)
    return _windowed(lambda t, pad: F.max_pool2d(t, 3, 2, pad), x, level, 3, 2, 1,
                     fill=float("-inf"))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], *,
                     level: Level, stride: int = 2, padding: int = 0, output_padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """``F.conv_transpose2d`` (``w`` ``(Cin, Cout / groups, k, k)``) of the
    whole level, as this rank's rows of the output level, whose rows are
    ``stride`` times the input's (the deconv decoders' k in {3, 5, 7, 9},
    stride 2, padding (k - 1) / 2, ``output_padding`` k % 2).  Output rows
    ``[stride lo, stride hi)`` read the input rows of
    :func:`_transpose_halo` past ``[lo, hi)`` (k = 3: none above and one
    below; 5: one and one; 7: one and two; 9: two and two); the
    transposed conv runs with no padding along the height on the halo'd
    tile, and the rank's rows are cropped from its output.  Zero rows
    past the image's edge add nothing, as in the unsharded op.  A
    replicated input gives the replicated output, sliced."""
    p = padding

    def op(t, tile=False):
        # a halo'd tile takes no padding and no output padding along the height
        return F.conv_transpose2d(t, w, bias, stride=stride, padding=(0, p) if tile else p,
                                  output_padding=(0, output_padding) if tile else output_padding,
                                  groups=groups)

    if level.part.size == 1:
        return op(x)
    k = w.shape[-1]
    out = Level(level.part, (level.rows - 1) * stride - 2 * p + k + output_padding)
    if out.rows != stride * level.rows:
        raise ValueError(f"a sharded transposed conv maps {level.rows} rows to "
                         f"{stride * level.rows}; this one gives {out.rows}")
    if not level.sharded:
        return out.take(op(x))
    lo, hi = level.bounds()
    above, below = _transpose_halo(k, stride, p)
    y = op(level.halo(x, above, below), tile=True)
    # output row j of the tile is image row j + stride (lo - above) - p
    return _like(y.narrow(2, stride * above + p, stride * (hi - lo)), x)


def upsample_bilinear2x(x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """Bilinear x2 (``align_corners=False``, ``ops/blocks.py``) of this
    rank's rows of ``level`` as its rows of the next one.  Output row 2m
    blends input rows m - 1 and m, row 2m + 1 rows m and m + 1, clamped
    to the image: a rank takes one halo row each side from its
    neighbours and none at the image's top or bottom, where the clamp
    to the edge is the tile's own.  The scale is exactly 2 and the tile
    starts a whole number of input rows into the image, so the tile's
    interpolation is the whole image's; the rank crops 2 rows for each
    halo row above.  ``level`` None: the unsharded op."""
    if level is None or level.part.size == 1:
        return B.upsample_bilinear2x(x)
    if not level.sharded:
        return level.up().take(B.upsample_bilinear2x(x))
    lo, hi = level.bounds()
    above, below = int(lo > 0), int(hi < level.rows)
    t = level.halo(x, 1, 1)
    t = t.narrow(2, 1 - above, t.shape[2] - (1 - above) - (1 - below))
    return _like(B.upsample_bilinear2x(t).narrow(2, 2 * above, 2 * (hi - lo)), x)


def _local2x(op, x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """``op(x)``, an op whose input row i gives output rows 2i and 2i + 1,
    of this rank's rows of ``level`` as its rows of the next one: a
    sharded level's rows ``[lo, hi)`` are the next one's ``[2 lo, 2 hi)``;
    from a replicated level the rank slices its rows of a sharded next
    one."""
    y = op(x)
    return y if level is None or level.sharded else level.up().take(y)


def upsample_nearest2x(x: torch.Tensor, level: Level) -> torch.Tensor:
    """Nearest x2 of this rank's rows of ``level`` (:func:`_local2x`)."""
    return _local2x(B.upsample_nearest2x, x, level)


def unpool_zero(x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """The zero-insertion unpool of this rank's rows of ``level``
    (:func:`_local2x`; input row i lands on row 2i, even rows stay even);
    ``level`` None: the unsharded op."""
    return _local2x(B.unpool_zero, x, level)


def pixel_shuffle(x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """The x2 pixel shuffle of this rank's rows of ``level``
    (:func:`_local2x`); ``level`` None: the unsharded op."""
    return _local2x(B.pixel_shuffle, x, level)


def k1_rows(level: Level):
    """This rank's K1 call at a decoder level whose input is ``level``:
    ``((first, end), window)``, the image rows its tile holds (outside
    the image: zero rows) and its row window ``(first, rows, olo, ohi)``
    for ``fused_decoder_stage(window=)``, the window this rank's rows of
    the upsampled level; None where that level is replicated (the call
    without a window).  A sharded input takes two halo rows each side; a
    replicated one feeding a sharded output is its own tile (the window
    may start on an odd row: 7 -> 14 rows at S = 2 gives [0, 7) and
    [7, 14))."""
    out = level.up()
    if not out.sharded:
        return None
    olo, ohi = out.bounds()
    lo, hi = level.bounds()
    if level.sharded:
        lo, hi = lo - 2, hi + 2
    return (lo, hi), (lo, level.rows, olo, ohi)


def k1_window(x: torch.Tensor, level: Level):
    """K1's operands for a decoder level whose input ``x`` holds this
    rank's rows of ``level``: ``(tile, window)`` for
    ``fused_decoder_stage(tile, ..., window=window)`` (:func:`k1_rows`),
    the tile ``x`` with its halo rows exchanged where ``level`` is
    sharded."""
    rows = k1_rows(level)
    if rows is None:
        return x, None
    return (level.halo(x, 2, 2) if level.sharded else x), rows[1]


def k1_tiles(rows: int, n_space: int):
    """Every rank's :func:`k1_rows` at a decoder level of ``rows`` input
    rows under ``n_space`` shards; empty where the level's output is
    replicated."""
    tiles = [k1_rows(Level(Partition(n_space, s), rows)) for s in range(n_space)]
    return [] if tiles[0] is None else tiles
