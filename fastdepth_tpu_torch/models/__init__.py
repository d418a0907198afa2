from fastdepth_tpu_torch.models.registry import (  # noqa: F401
    Model,
    build,
    fastdepth_pruned,
    fastdepth_unpruned,
    from_name,
)
