"""The port's device mesh — counterpart of ``fastdepth_tpu/parallel/mesh.py``.

A JAX mesh is N devices that one or more processes drive; the port's is a
``torch.distributed`` process group with one rank per device
(``parallel/distributed.py`` starts the ranks).  Its one axis is
``data``, the batch: each rank holds its rows of every global batch
(``put_sharded``) and an identical copy of the state (``put_replicated``),
and a per-row result becomes global by an all-gather in rank order
(``fetch_global``).  The reductions a global batch needs — the BatchNorm
moments (``ops.blocks.batch_norm_train``), the masked-L1 denominator
(``train.loss``), the gradient (``train.trainer``) — are explicit
collectives over ``Mesh.group``: XLA inserted them from the shardings,
eager PyTorch does not.

The ``space`` axis (H-sharded inference, ``make_mesh_2d``,
``--mesh-spatial``) is not ported yet: every conv, and K1's dw5x5, would
need its halo rows exchanged by hand (ROADMAP A12b).  A tensor lives on
its rank's device, so JAX's sharding objects (``replicate``,
``shard_batch``, ``shard_activations``) have no counterpart.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"

SPACE_NOT_PORTED = ("the 'space' mesh axis (H-sharded inference: make_mesh(n, 'space'), "
                    "make_mesh_2d, --mesh-spatial) is not ported yet: ROADMAP A12b")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D ``data`` mesh: its axis names, the process
    group the mesh's collectives run over, and this rank's device."""

    axis_names: Tuple[str, ...]
    group: Any
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """The mesh over every rank of the initialized process group (one
    rank per device).  ``num_devices`` must equal the group's size: more
    raises JAX's "need N devices" error, fewer is refused too (the ranks
    outside the mesh would feed batches nobody reads).  The device is the
    rank's card under NCCL, the CPU under gloo."""
    if axis_name == SPACE_AXIS:
        raise NotImplementedError(SPACE_NOT_PORTED)
    if axis_name != DATA_AXIS:
        raise ValueError(
            f"mesh axes ({axis_name!r},) carry neither "
            f"'{DATA_AXIS}' nor '{SPACE_AXIS}'; sharding would silently "
            f"replicate every activation (use make_mesh)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group, one rank per device: "
            "start the ranks with --mesh-devices N or --coord "
            "(parallel.distributed.launch), or call torch.distributed.init_process_group")
    have = dist.get_world_size()
    n = have if num_devices is None else num_devices
    if n > have:
        raise ValueError(f"need {n} devices for the mesh, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} devices in a job of {have} ranks: the port's mesh "
                         f"spans every rank, one rank per device (start {n} ranks)")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh((axis_name,), dist.group.WORLD, device)


def make_mesh_2d(n_data: int, n_space: int) -> Mesh:
    raise NotImplementedError(SPACE_NOT_PORTED)


def check_cli_mesh(n_data: Optional[int], n_space: Optional[int],
                   batch_size: Optional[int] = None) -> None:
    """The mesh flags' checks, SystemExit with the flag names, before any
    rank starts or any checkpoint loads: the batch divides by
    ``--mesh-devices``; ``--mesh-spatial`` is refused (ROADMAP A12b)."""
    if n_data and batch_size is not None and batch_size % n_data:
        raise SystemExit(
            f"--batch-size {batch_size} must divide by --mesh-devices {n_data}")
    if n_space:
        raise SystemExit(SPACE_NOT_PORTED)


def mesh_from_cli(n_data: Optional[int], n_space: Optional[int],
                  batch_size: Optional[int] = None) -> Optional[Mesh]:
    """Shared CLI mesh rule (cli.train / cli.evaluate), run on every rank:
    ``--mesh-devices N`` -> a 1-D data mesh over the job's N ranks;
    neither flag -> None.  Checks as :func:`check_cli_mesh`."""
    check_cli_mesh(n_data, n_space, batch_size)
    return make_mesh(n_data) if n_data else None


def put_sharded(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch (what its loader yields:
    ``BatchLoader(**shard_kwargs())``) onto the rank's device."""
    return torch.as_tensor(np.asarray(batch)).to(mesh.device)


def put_replicated(tree, mesh: Mesh):
    """A copy of a host-identical tensor or module tree on the rank's
    device.  Every rank must pass the same values (seeded init or the
    same checkpoint), as in the JAX package's single-program convention."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(mesh.device, copy=True)
    return copy.deepcopy(tree).to(mesh.device)


def fetch_global(x, mesh: Optional[Mesh] = None, dim: int = 0) -> np.ndarray:
    """A tensor as host numpy.  With ``mesh``, ``x`` holds this rank's
    rows along ``dim`` and the result is the global array: every rank's
    rows, all-gathered in rank order (a collective: every rank calls it).
    Without, ``x`` is replicated or local and comes back as it is."""
    if mesh is None:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim).cpu().numpy()
