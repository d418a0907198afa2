"""Data parallelism on the port: one ``torch.distributed`` rank per device
(counterpart of ``fastdepth_tpu.parallel``)."""

from fastdepth_tpu_torch.parallel.distributed import (  # noqa: F401
    add_distributed_args,
    init_distributed,
    is_primary,
    launch,
    shard_kwargs,
)
from fastdepth_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    fetch_global,
    make_mesh,
    make_mesh_2d,
    mesh_from_cli,
    put_replicated,
    put_sharded,
)
