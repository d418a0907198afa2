"""Data pipeline: the port's copy of the host half of ``fastdepth_tpu/data``,
and its own PyTorch counterpart of the device augmentation
(``device_aug.py``)."""

from fastdepth_tpu_torch.data.nyu import NYUDataset  # noqa: F401
from fastdepth_tpu_torch.data.loader import BatchLoader  # noqa: F401
