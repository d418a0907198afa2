"""Height sharding for the mesh's ``space`` axis: which rows each rank
holds at each level of a forward, and the halo exchange between ranks.

The JAX package gave XLA's SPMD partitioner a height-sharded activation
and let it exchange every conv's halo rows (``fastdepth_tpu/parallel/
mesh.py``).  Eager PyTorch does neither, so this module owns both, for
the MobileNet encoder + NNConv decoder family (:func:`supports`):

* **The row partition.**  A level of ``rows`` rows is *sharded* when it
  splits into S equal shards of at least :data:`MIN_ROWS` rows, the
  widest halo the model's convs need (2 for a 5x5, so that a halo always comes
  from one neighbour); rank s of the space group then holds rows
  ``[s rows / S, (s + 1) rows / S)``.  Otherwise the level is computed
  *replicated*, whole on every rank of the group, and a rank slices its
  rows back out where the next level is sharded again (:meth:`Level.
  take`).  Halving keeps the rule monotone: a sharded level's double is
  sharded, a replicated level's half replicated.  At 224^2 and S = 2 the
  levels 224 ... 14 are sharded and 7 is replicated; at S = 8 the levels
  28 and below.  Replicated compute is exact (the same rows on every
  rank) and costs each rank the whole of those small levels.
* **The exchange.**  :meth:`Level.halo` gives a rank's rows the rows
  above and below it that a conv window reads: from the neighbours over
  the space group with ``dist.batch_isend_irecv`` (point-to-point, which
  NCCL and gloo both carry), zero rows at the image's top and bottom.
* **The convs.**  :func:`conv2d` runs a k x k conv of a sharded level as
  an exchange, then ``F.conv2d`` with no padding along the height on the
  halo'd tile (cuDNN on the card, as the unsharded path); a pointwise
  conv needs no halo; a conv from a sharded level into a replicated one
  gathers its input first.  :func:`k1_window` gives K1 its tile and row
  window (``ops/cuda/fused_decoder.py``).
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

# the widest halo of the family's convs: the decoder's 5x5 (the encoder's
# 3x3 needs 1 row)
MIN_ROWS = 2
# the decoders whose convs need at most MIN_ROWS of halo and whose
# upsampling is nearest x2 (models/decoders.py)
DECODERS = frozenset(f"nnconv{k}{dw}" for k in (3, 5) for dw in ("", "dw"))

SPACE_ZOO_NOT_PORTED = (
    "the 'space' mesh axis covers the MobileNet encoder + NNConv decoder family "
    "(mobilenet-nnconv{{3,5}}[dw], skip add or concat, pruned or not); "
    "{what} needs its own halo rule under it (transposed convs, pools, the "
    "zero-unpool, bilinear and shuffle upsampling): ROADMAP A12c")


@dataclasses.dataclass(frozen=True)
class Partition:
    """One rank's place on the space axis: the group's ``size`` S, this
    rank's ``rank`` s in it, the group, and the group's global ranks in
    space order (point-to-point peers are named by global rank)."""

    size: int
    rank: int
    group: Any = None
    ranks: Tuple[int, ...] = (0,)

    def sharded(self, rows: int) -> bool:
        """True when a level of ``rows`` rows is split over the group."""
        return self.size > 1 and rows % self.size == 0 and rows // self.size >= MIN_ROWS

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
        space group; the tensor itself where the level is replicated)."""
        if not self.sharded:
            return x
        t = x.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.part.size)]
        dist.all_gather(parts, t, group=self.part.group)
        return _like(torch.cat(parts, 2), x)

    def halo(self, x: torch.Tensor, above: int, below: int) -> torch.Tensor:
        """This rank's rows with ``above`` rows of the rank before and
        ``below`` of the rank after (zero rows at the image's top and
        bottom): a sharded level only, whose shards hold at least as many
        rows as either halo."""
        part = self.part
        lo, hi = self.bounds()
        if not self.sharded or max(above, below) > hi - lo:
            raise ValueError(f"a halo of {above} + {below} rows needs a level sharded into "
                             f"shards of at least that many rows; got {self.rows} rows over "
                             f"{part.size} ranks")
        n, c, h, w = x.shape
        s = part.rank
        ops, top, bottom = [], None, None
        if above:
            top = x.new_zeros((n, c, above, w))
            if s > 0:
                ops.append(dist.P2POp(dist.irecv, top, part.ranks[s - 1], part.group))
            if s < part.size - 1:
                ops.append(dist.P2POp(dist.isend, x[:, :, h - above:].contiguous(),
                                      part.ranks[s + 1], part.group))
        if below:
            bottom = x.new_zeros((n, c, below, w))
            if s < part.size - 1:
                ops.append(dist.P2POp(dist.irecv, bottom, part.ranks[s + 1], part.group))
            if s > 0:
                ops.append(dist.P2POp(dist.isend, x[:, :, :below].contiguous(),
                                      part.ranks[s - 1], part.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _like(torch.cat([t for t in (top, x, bottom) if t is not None], 2), x)


def supports(cfg) -> bool:
    """True when a height-sharded forward covers the architecture: a
    MobileNet encoder and a :data:`DECODERS` decoder, skips or not."""
    return cfg.encoder == "mobilenet" and cfg.decoder in DECODERS


def check_model(cfg) -> None:
    """Refuse the rest of the zoo under a ``space`` axis, naming A12c."""
    if not supports(cfg):
        raise ValueError(SPACE_ZOO_NOT_PORTED.format(
            what=f"encoder={cfg.encoder!r} decoder={cfg.decoder!r}"))


def input_level(part: Optional[Partition], x: torch.Tensor, cfg) -> Optional[Level]:
    """The level of a height-sharded forward's NHWC input ``x`` (this
    rank's even share of the image's rows) under ``part``; None without
    one.  The image's level must be sharded (rows divisible by S, at
    least :data:`MIN_ROWS` a rank), so the output splits as the input did."""
    if part is None:
        return None
    check_model(cfg)
    level = Level(part, x.shape[1] * part.size)
    if part.size > 1 and not level.sharded:
        raise ValueError(f"a {level.rows}-row image does not split into {part.size} shards "
                         f"of at least {MIN_ROWS} rows")
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


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], *, level: Level,
           stride: int = 1, padding: Optional[int] = None, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, bias, stride, padding, groups=groups)`` of the
    whole level, as this rank's rows of the output level (a square OIHW
    kernel, ``padding`` None for (k - 1) / 2).  Output rows ``[olo, ohi)``
    read input rows ``stride olo - p .. stride (ohi - 1) - p + k - 1``:
    with a sharded input and output the halo is what that range reaches
    past the rank's rows (3x3, stride 2 on even shards: one row above and
    none below), exchanged, then the conv runs with no padding along the
    height.  A replicated input gives the replicated output, sliced; a
    sharded input into a replicated output is gathered first."""
    k = w.shape[-1]
    p = (k - 1) // 2 if padding is None else padding
    out = level.down(k, stride, p)
    if level.part.size == 1 or (k == 1 and stride == 1 and p == 0):
        return F.conv2d(x, w, bias, stride=stride, padding=p, groups=groups)
    if not level.sharded:
        return out.take(F.conv2d(x, w, bias, stride=stride, padding=p, groups=groups))
    if not out.sharded:
        return F.conv2d(level.gather(x), w, bias, stride=stride, padding=p, groups=groups)
    lo, hi = level.bounds()
    olo, ohi = out.bounds()
    above, below = lo - (stride * olo - p), stride * (ohi - 1) - p + k - hi
    return F.conv2d(level.halo(x, above, below), w, bias, stride=stride, padding=(0, p),
                    groups=groups)


def upsample_nearest2x(x: torch.Tensor, level: Level) -> torch.Tensor:
    """Nearest x2 of this rank's rows of ``level``: a rank's rows map to
    twice the rows, which are its rows of the next level where ``level``
    is sharded; from a replicated level the rank slices its rows of a
    sharded next one."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    return y if level.sharded else level.up().take(y)


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
