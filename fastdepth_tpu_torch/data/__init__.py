"""Host data pipeline: the port's copy of ``fastdepth_tpu/data`` (not its
JAX device augmentation)."""

from fastdepth_tpu_torch.data.nyu import NYUDataset  # noqa: F401
from fastdepth_tpu_torch.data.loader import BatchLoader  # noqa: F401
