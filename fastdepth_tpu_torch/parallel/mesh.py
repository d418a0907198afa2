"""The port's device mesh — counterpart of ``fastdepth_tpu/parallel/mesh.py``.

A JAX mesh is N devices that one or more processes drive; the port's is a
``torch.distributed`` process group with one rank per device
(``parallel/distributed.py`` starts the ranks).  Its axes are JAX's:

* ``data``, the batch: each rank holds its rows of every global batch
  (``put_sharded``) and an identical copy of the state
  (``put_replicated``), and a per-row result becomes global by an
  all-gather in rank order (``fetch_global``).  The reductions a global
  batch needs — the BatchNorm moments (``ops.blocks.batch_norm_train``),
  the masked-L1 denominator (``train.loss``), the gradient
  (``train.trainer``), the evaluator's metric stack — are explicit
  collectives over ``Mesh.group``: XLA inserted them from the shardings,
  eager PyTorch does not.
* ``space``, the image height (inference and evaluation only): each rank
  holds its rows of every image, and the forward exchanges each conv's
  halo rows with its neighbours by hand (``parallel/spatial.py``, the
  rows at each level and the exchange); the per-image metric sums close
  with an all-reduce over ``Mesh.space_group``.

Meshes are 1-D ``('data',)`` (``make_mesh(n)``), 1-D ``('space',)``
(``make_mesh(n, 'space')``) or 2-D ``('data', 'space')``
(``make_mesh_2d``).  Rank ``r`` sits at ``(d, s) = (r // S, r % S)``:
space is the minor axis, as JAX's ``reshape(n_data, n_space)`` lays it
out, so a rank's space neighbours are its neighbouring ranks.  The data
group of a 1-D data mesh is WORLD; the others are made with
``dist.new_group``, every group on every rank in one fixed order.  A
tensor lives on its rank's device, so JAX's sharding objects
(``replicate``, ``shard_batch``, ``shard_activations``) have no
counterpart.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fastdepth_tpu_torch.parallel.spatial import Partition

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: its axis names, the process group of
    its ``data`` axis (the collectives over the batch), this rank's
    device, and for a ``space`` axis the group of its space axis and that
    group's global ranks in space order."""

    axis_names: Tuple[str, ...]
    group: Any
    device: torch.device
    space_group: Any = None
    space_ranks: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        """The ``data`` axis's size (1 without one)."""
        return dist.get_world_size(self.group) if DATA_AXIS in self.axis_names else 1

    @property
    def rank(self) -> int:
        """This rank's place on the ``data`` axis."""
        return dist.get_rank(self.group) if DATA_AXIS in self.axis_names else 0

    @property
    def space_size(self) -> int:
        return len(self.space_ranks) if SPACE_AXIS in self.axis_names else 1

    @property
    def space_rank(self) -> int:
        return self.space_ranks.index(dist.get_rank()) if SPACE_AXIS in self.axis_names else 0

    @property
    def shape(self) -> dict:
        sizes = {DATA_AXIS: self.size, SPACE_AXIS: self.space_size}
        return {name: sizes[name] for name in self.axis_names}

    def partition(self) -> Optional[Partition]:
        """The space axis's row partition for ``parallel/spatial.py``
        (None without a ``space`` axis)."""
        if SPACE_AXIS not in self.axis_names:
            return None
        return Partition(self.space_size, self.space_rank, self.space_group, self.space_ranks)


def _device() -> torch.device:
    """The rank's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world(n: Optional[int], what: str) -> int:
    """Check that the mesh spans every rank of the initialized group."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a torch.distributed process group, one rank per device: "
            "start the ranks with --mesh-devices N or --coord "
            "(parallel.distributed.launch), or call torch.distributed.init_process_group")
    have = dist.get_world_size()
    n = have if n is None else n
    if n > have:
        raise ValueError(f"need {n} devices for the mesh, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} devices in a job of {have} ranks: the port's mesh "
                         f"spans every rank, one rank per device (start {n} ranks)")
    return n


def _new_group(ranks):
    """WORLD where ``ranks`` are all of it, else a new group (every rank
    must call this for every group, in the same order)."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """The 1-D mesh over every rank of the initialized process group (one
    rank per device).  ``num_devices`` must equal the group's size: more
    raises JAX's "need N devices" error, fewer is refused too (the ranks
    outside the mesh would feed batches nobody reads).  ``'space'``
    shards the image height over all of them (:func:`make_mesh_2d` with
    one data row)."""
    if axis_name == SPACE_AXIS:
        n = _world(num_devices, "make_mesh")
        return _mesh(1, n, (SPACE_AXIS,))
    if axis_name != DATA_AXIS:
        raise ValueError(
            f"mesh axes ({axis_name!r},) carry neither "
            f"'{DATA_AXIS}' nor '{SPACE_AXIS}'; sharding would silently "
            f"replicate every activation (use make_mesh)")
    _world(num_devices, "make_mesh")
    return Mesh((DATA_AXIS,), dist.group.WORLD, _device())


def make_mesh_2d(n_data: int, n_space: int) -> Mesh:
    """The 2-D ``(data, space)`` mesh: batch sharded ``n_data``-way, image
    height ``n_space``-way, over ``n_data * n_space`` ranks (all of the
    job's), rank ``d * n_space + s`` at ``(d, s)``."""
    need = n_data * n_space
    if dist.is_initialized() and need > dist.get_world_size():
        raise ValueError(f"need {need} devices for a {n_data}x{n_space} mesh, "
                         f"have {dist.get_world_size()}")
    _world(need, "make_mesh_2d")
    return _mesh(n_data, n_space, (DATA_AXIS, SPACE_AXIS))


def _mesh(n_data: int, n_space: int, axes: Tuple[str, ...]) -> Mesh:
    """The groups of an ``n_data`` x ``n_space`` layout, made on every rank
    in one order (the space groups, then the data groups), and this
    rank's view."""
    rank = dist.get_rank()
    space_groups = [tuple(d * n_space + s for s in range(n_space)) for d in range(n_data)]
    data_groups = [tuple(d * n_space + s for d in range(n_data)) for s in range(n_space)]
    made = {ranks: _new_group(ranks) for ranks in space_groups + data_groups}
    d, s = divmod(rank, n_space)
    return Mesh(axes, made[data_groups[s]], _device(), space_group=made[space_groups[d]],
                space_ranks=space_groups[d])


def check_cli_mesh(n_data: Optional[int], n_space: Optional[int],
                   image_height: Optional[int] = None,
                   batch_size: Optional[int] = None) -> None:
    """The mesh flags' checks, SystemExit with the flag names and the JAX
    package's messages, before any rank starts or any checkpoint loads:
    the batch divides by ``--mesh-devices``, the image height by
    ``--mesh-spatial``."""
    if n_data and batch_size is not None and batch_size % n_data:
        raise SystemExit(
            f"--batch-size {batch_size} must divide by --mesh-devices {n_data}")
    if n_space and image_height is not None and image_height % n_space:
        raise SystemExit(
            f"--mesh-spatial {n_space} must divide the "
            f"{image_height}-row image height")


def mesh_from_cli(n_data: Optional[int], n_space: Optional[int],
                  image_height: Optional[int] = None,
                  batch_size: Optional[int] = None) -> Optional[Mesh]:
    """Shared CLI mesh rule (cli.evaluate / cli.serve / cli.train), run on
    every rank: ``--mesh-devices N --mesh-spatial S`` -> an (N or 1, S)
    2-D mesh over the job's N x S ranks; N alone -> a 1-D data mesh;
    neither -> None.  Checks as :func:`check_cli_mesh`."""
    check_cli_mesh(n_data, n_space, image_height, batch_size)
    if n_space:
        return make_mesh_2d(n_data or 1, n_space)
    return make_mesh(n_data) if n_data else None


def put_sharded(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's block of an NHWC batch onto the rank's device:
    ``batch`` holds this rank's rows of the global batch (what its loader
    yields: ``BatchLoader(**shard_kwargs(mesh=mesh))``) at the full
    height, and under a ``space`` axis the rank takes its rows of the
    height."""
    t = torch.as_tensor(np.asarray(batch))
    part = mesh.partition()
    if part is not None:
        t = take_rows(t, part, 1)
    return t.to(mesh.device)


def take_rows(t: torch.Tensor, part: Partition, dim: int) -> torch.Tensor:
    """This rank's even share of ``t``'s rows along ``dim`` (the input
    and output of a height-sharded forward split evenly: the image height
    divides by the space axis)."""
    rows = t.shape[dim]
    if rows % part.size:
        raise ValueError(f"a {rows}-row image does not split over the {part.size}-way "
                         f"'{SPACE_AXIS}' axis")
    k = rows // part.size
    return t.narrow(dim, part.rank * k, k)


def block_of(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``(data, space)`` block of a whole global NHWC batch:
    its data rows of dim 0, then its rows of the height."""
    n = batch.shape[0] // mesh.size
    t = batch.narrow(0, mesh.rank * n, n)
    part = mesh.partition()
    return t if part is None else take_rows(t, part, 1)


def put_replicated(tree, mesh: Mesh):
    """A copy of a host-identical tensor or module tree on the rank's
    device.  Every rank must pass the same values (seeded init or the
    same checkpoint), as in the JAX package's single-program convention."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(mesh.device, copy=True)
    return copy.deepcopy(tree).to(mesh.device)


def fetch_global(x, mesh: Optional[Mesh] = None, dim: int = 0,
                 space_dim: Optional[int] = None) -> np.ndarray:
    """A tensor as host numpy.  With ``mesh``, ``x`` holds this rank's
    rows along ``dim`` and the result is the global array: every rank's
    rows, all-gathered in rank order over the data group (a collective:
    every rank calls it).  ``space_dim``: ``x`` also holds this rank's
    rows of the height along it, gathered first over the space group (a
    per-image result that the space ranks share, as the metric stack,
    leaves it None).  Without a mesh, ``x`` is replicated or local and
    comes back as it is."""
    if mesh is None:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x.detach().contiguous()
    if space_dim is not None and SPACE_AXIS in mesh.axis_names:
        parts = [torch.empty_like(t) for _ in range(mesh.space_size)]
        dist.all_gather(parts, t, group=mesh.space_group)
        t = torch.cat(parts, space_dim)
    if DATA_AXIS in mesh.axis_names:
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        t = torch.cat(parts, dim)
    return t.cpu().numpy()
